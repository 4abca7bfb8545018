// Kernel K5: stress + crisis jumps + funding spread + leverage/expense/
// financing + AR(1) tracking error for all six assets. A block per 32
// trials (lane = trial): one stress warp feeds a shared-memory ring of
// days, three asset warps run the six assets' tracking-error chains from
// it.
//
// Replaces letf_tpu/ops/pallas_compose.py::_compose_kernel (pallas_call at
// pallas_compose.py:344, entry pallas_compose_generate) on the general
// [S, B] path. The day math is compose_day.cuh, shared with kernel K3; K5
// runs the tracking-error chain for every asset and bounds each net return
// to [-0.999, 10] without repairing non-finite values (the path's
// _finish_path repairs). Outputs: six ETF return planes [6, S, B], the
// jump-adjusted SPY and QQQ streams, the cash return [S, B], and per-trial
// jump count / liquidity sum / credit sum [3, B]. The plain PyTorch version
// is ops/compose.py::compose_plain.
//
// What bounds it on the H100 (PERF.md holds the measurements). Its 15
// [S, B] planes (6 in, 9 out) coalesce across a warp and move ~7 GB at
// 16,384 trials x 30 years: 2.2 ms at 3.35 TB/s. The first port ran one
// thread a trial in 32-thread blocks: each warp issued the whole day alone
// (~14 transcendentals, six tanhf, six IEEE divisions with their slow-path
// branches, nine stores) and took ~22 ms at 16,384 trials and at the
// report's 650 alike. Only liq and cred (stress) and each asset's te and
// bias carry from day to day, so the day splits:
// - warp 0 (stress) carries liq and cred: it loads spy, qqq, vix, irx and
//   the regime a day ahead, draws the stress normals, the jump uniform and
//   the t5 jump size, runs stress_day, stores the spy_a, qqq_a and cash
//   planes and writes what the assets need of the day (R_*) into the ring
//   (~490 instructions a day);
// - asset warp w carries assets 2w and 2w + 1 (te and bias): it reads the
//   day from the ring and the TLT stream a day ahead, draws its assets'
//   t_polar, runs asset_day (its tanh clip) and stores their planes, 128
//   bytes a row (~250 instructions an asset-day);
// - each of the NSLOT ring tiles of D days has a FULL and an EMPTY named
//   barrier, so the stress warp runs up to NSLOT tiles ahead and no warp
//   meets a whole-block barrier in the day loop; a ragged last strip
//   computes on the last trial's inputs and stores nothing;
// - every unit (a stress day, an asset day) runs by FastMath (fastmath.cuh:
//   division and square root without their slow-path branches, sine and
//   cosine by the library's fast path) and again by IeeeMath from the
//   saved carry where FastMath's range flag falls, so every value is the
//   first port's bit for bit (chip_smoke.py holds its output digests).
// At 16,384 trials (4 blocks, 16 warps an SM) it is issue bound: ~2,000
// instructions a 32-trial day. At the report's 650 (21 blocks) each warp's
// own day is the limit, the asset warps' the longest. Six asset warps of
// one asset each need 72 registers for 4 blocks an SM and spill; two-day
// units (both days by FastMath, one recompute) gained ~5% for 32 bytes of
// local memory; neither is used.

#include "compose_day.cuh"

namespace {

using namespace compose_day;

// Constants table (ops/compose.py::kernel_consts).
enum { K_EMA, K_ONE_M_EMA, K_UND, K_DF = K_UND + NA, K_M2DF = K_DF + NA,
       NK = K_M2DF + NA };
// One lane-day of the ring: what the asset warps read of the stress day.
enum { R_SPY, R_QQQ, R_RF, R_SPREAD, R_VMULT, R_RMULT, NRING };
constexpr int APW = 2;                // assets an asset warp carries
constexpr int NT = 32 * (1 + NA / APW);   // threads a block
constexpr int D = 16;                 // days a ring tile holds
constexpr int NSLOT = 2;              // ring tiles
constexpr int MIN_BLOCKS = 4;         // resident blocks an SM
static_assert(NA % APW == 0, "every asset warp carries APW assets");
static_assert(2 * NSLOT < 16, "FULL and EMPTY barriers fit the 16 ids");

struct Tables {
  float spa[NSP], spd[NSP], ap[NAP * NA], k[NK];
};

struct Shared {
  Tables tb;
  float ring[NSLOT][D][NRING][32];
};

struct Io {
  const float *spy, *qqq, *tlt, *vix, *irx, *regime;
  float *etf, *spy_a, *qqq_a, *cash;
};

struct Args {
  Io io;
  const int* ids;
  uint32_t s0, s1;
  int S, B;
  float* sums;
};

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(NT) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(NT) : "memory");
}
// Named barriers: 0 is __syncthreads; FULL of slot s is 1 + s, EMPTY is
// 1 + NSLOT + s.
__device__ __forceinline__ int full_bar(int s) { return 1 + s; }
__device__ __forceinline__ int empty_bar(int s) { return 1 + NSLOT + s; }

// The stress warp's inputs of one trial-day.
struct In {
  float spy, qqq, vix, irx, reg;
};

__device__ __forceinline__ In load_in(const Io& io, size_t at) {
  return In{io.spy[at], io.qqq[at], io.vix[at], io.irx[at], io.regime[at]};
}

// Stress day t of a lane into ring row v: liq and cred carried, the jump,
// liquidity and credit sums added, the spy_a, qqq_a and cash planes stored.
template <bool FIRST>
__device__ __forceinline__ void stress_step(const Tables& T, const Args& a,
                                            const In& x, uint32_t dk, int t,
                                            int b, float& liq, float& cred,
                                            float& jc, float& ls, float& cs,
                                            float (*v)[32], int lane) {
  float l = liq, c = cred;
  FastMath fm;
  DayStress ds = stress_day<FIRST>(T.spa, T.spd, dk, l, c, x.spy, x.qqq,
                                   x.vix, x.irx, x.reg, fm);
  float cash = fm.div(g2(T.spa, T.spd, CASH_RATE, x.reg), 252.0f);
  if (!fm.ok) {
    l = liq;
    c = cred;
    IeeeMath im;
    ds = stress_day<FIRST>(T.spa, T.spd, dk, l, c, x.spy, x.qqq, x.vix,
                           x.irx, x.reg, im);
    cash = g2(T.spa, T.spd, CASH_RATE, x.reg) / 252.0f;
  }
  liq = l;
  cred = c;
  jc = jc + ds.jump_on;
  ls = ls + ds.liq_n;
  cs = cs + ds.cred_n;
  v[R_SPY][lane] = ds.spy_a;
  v[R_QQQ][lane] = ds.qqq_a;
  v[R_RF][lane] = ds.risk_free;
  v[R_SPREAD][lane] = ds.spread;
  v[R_VMULT][lane] = ds.vix_mult;
  v[R_RMULT][lane] = ds.regime_mult;
  if (b < a.B) {
    const size_t at = (size_t)t * a.B + b;
    a.io.spy_a[at] = ds.spy_a;
    a.io.qqq_a[at] = ds.qqq_a;
    a.io.cash[at] = cash;
  }
}

// The stress warp: every tile of the ring in order.
__device__ __forceinline__ void stress_role(Shared& sh, const Args& a,
                                            int lane, int b, int bc,
                                            int ntile) {
  const uint32_t lane_key = letf_lane_key(a.ids[bc], a.s0);
  float liq = 0.0f, cred = 0.0f, jc = 0.0f, ls = 0.0f, cs = 0.0f;
  In nxt = load_in(a.io, bc);
  for (int k = 0; k < ntile; ++k) {
    const int s = k % NSLOT;
    if (k >= NSLOT) bar_sync(empty_bar(s));
    const int nd = min(D, a.S - k * D);
    int j = 0;
    if (k == 0) {
      const In x = nxt;
      if (1 < a.S) nxt = load_in(a.io, (size_t)a.B + bc);
      stress_step<true>(sh.tb, a, x, letf_day_key(lane_key, 0u, a.s1), 0, b,
                        liq, cred, jc, ls, cs, sh.ring[s][0], lane);
      j = 1;
    }
#pragma unroll 1
    for (; j < nd; ++j) {
      const int t = k * D + j;
      const In x = nxt;
      if (t + 1 < a.S) nxt = load_in(a.io, (size_t)(t + 1) * a.B + bc);
      stress_step<false>(sh.tb, a, x,
                         letf_day_key(lane_key, (uint32_t)t, a.s1), t, b,
                         liq, cred, jc, ls, cs, sh.ring[s][j], lane);
    }
    bar_arrive(full_bar(s));
  }
  if (b < a.B) {
    a.sums[b] = jc;
    a.sums[(size_t)a.B + b] = ls;
    a.sums[2 * (size_t)a.B + b] = cs;
  }
}

// Asset as's day from the ring row v (by FastMath, again by IeeeMath from
// the saved carry where its flag falls), bounded and stored.
template <bool FIRST>
__device__ __forceinline__ void asset_step(const Tables& T, const Args& a,
                                           int as, int ui, float df,
                                           float m2df, const float (*v)[32],
                                           float tlt, uint32_t dk, int t,
                                           int b, float& te, float& bias,
                                           int lane) {
  DayStress d{};
  d.risk_free = v[R_RF][lane];
  d.spread = v[R_SPREAD][lane];
  d.vix_mult = v[R_VMULT][lane];
  d.regime_mult = v[R_RMULT][lane];
  const float src = ui == 0 ? v[R_SPY][lane]
                            : (ui == 1 ? v[R_QQQ][lane] : tlt);
  const float te0 = te, bias0 = bias;
  FastMath fm;
  float e = asset_day<FIRST>(T.ap, as, src, d, dk, df, m2df, T.k[K_EMA],
                             T.k[K_ONE_M_EMA], te, bias, fm);
  if (!fm.ok) {
    te = te0;
    bias = bias0;
    IeeeMath im;
    e = asset_day<FIRST>(T.ap, as, src, d, dk, df, m2df, T.k[K_EMA],
                         T.k[K_ONE_M_EMA], te, bias, im);
  }
  if (b < a.B)
    a.io.etf[((size_t)as * a.S + t) * a.B + b] = jclip(e, -0.999f, 10.0f);
}

// Day t of asset warp w's assets from the ring row v; the TLT stream
// (where an asset is levered on it) loads a day ahead.
template <bool FIRST>
__device__ __forceinline__ void asset_days(
    const Tables& T, const Args& a, int w, const int* ui, const float* df,
    const float* m2df, bool tlt_used, float& tlt_nxt, const float (*v)[32],
    uint32_t lane_key, int t, int b, int bc, float* te, float* bias,
    int lane) {
  const float tlt = tlt_nxt;
  if (tlt_used && t + 1 < a.S) tlt_nxt = a.io.tlt[(size_t)(t + 1) * a.B + bc];
  const uint32_t dk = letf_day_key(lane_key, (uint32_t)t, a.s1);
#pragma unroll
  for (int i = 0; i < APW; ++i)
    asset_step<FIRST>(T, a, w * APW + i, ui[i], df[i], m2df[i], v, tlt, dk,
                      t, b, te[i], bias[i], lane);
}

// Asset warp w: assets w * APW .. w * APW + APW - 1, every tile of the
// ring in order.
__device__ __forceinline__ void asset_role(Shared& sh, const Args& a, int w,
                                           int lane, int b, int bc,
                                           int ntile) {
  const uint32_t lane_key = letf_lane_key(a.ids[bc], a.s0);
  int ui[APW];
  float df[APW], m2df[APW], te[APW], bias[APW];
  bool tlt_used = false;
#pragma unroll
  for (int i = 0; i < APW; ++i) {
    const int as = w * APW + i;
    ui[i] = (int)sh.tb.k[K_UND + as];
    df[i] = sh.tb.k[K_DF + as];
    m2df[i] = sh.tb.k[K_M2DF + as];
    te[i] = 0.0f;
    bias[i] = 0.0f;
    tlt_used |= ui[i] == 2;
  }
  float tlt_nxt = tlt_used ? a.io.tlt[bc] : 0.0f;
  for (int k = 0; k < ntile; ++k) {
    const int s = k % NSLOT;
    bar_sync(full_bar(s));
    const int nd = min(D, a.S - k * D);
    int j = 0;
    if (k == 0) {
      asset_days<true>(sh.tb, a, w, ui, df, m2df, tlt_used, tlt_nxt,
                       sh.ring[s][0], lane_key, 0, b, bc, te, bias, lane);
      j = 1;
    }
#pragma unroll 1
    for (; j < nd; ++j)
      asset_days<false>(sh.tb, a, w, ui, df, m2df, tlt_used, tlt_nxt,
                        sh.ring[s][j], lane_key, k * D + j, b, bc, te, bias,
                        lane);
    // The stress warp waits on this slot only for the tile NSLOT ahead.
    if (k + NSLOT < ntile) bar_arrive(empty_bar(s));
  }
}

// Warp 0 runs the stress chain, warps 1..NA/APW the assets.
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
compose_kernel(const float* __restrict__ sp, const float* __restrict__ ap,
               const float* __restrict__ kc, Args a) {
  __shared__ Shared sh;
  for (int i = threadIdx.x; i < NSP; i += NT) {
    sh.tb.spa[i] = sp[2 * i];
    sh.tb.spd[i] = sp[2 * i + 1] - sp[2 * i];
  }
  for (int i = threadIdx.x; i < NAP * NA; i += NT) sh.tb.ap[i] = ap[i];
  for (int i = threadIdx.x; i < NK; i += NT) sh.tb.k[i] = kc[i];
  __syncthreads();
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Lanes past B (the ragged last strip) run on the last trial's inputs
  // and store nothing, so every warp meets every barrier.
  const int b = blockIdx.x * 32 + lane;
  const int bc = b < a.B ? b : a.B - 1;
  const int ntile = (a.S + D - 1) / D;
  if (warp == 0)
    stress_role(sh, a, lane, b, bc, ntile);
  else
    asset_role(sh, a, warp - 1, lane, b, bc, ntile);
}

}  // namespace

extern "C" int letf_compose(const float* sp, const float* ap, const float* kc,
                            const int* ids, unsigned int s0, unsigned int s1,
                            const float* spy, const float* qqq,
                            const float* tlt, const float* vix,
                            const float* irx, const float* regime, int S,
                            int B, float* etf, float* spy_a, float* qqq_a,
                            float* cash, float* sums, void* stream) {
  const Args a{{spy, qqq, tlt, vix, irx, regime, etf, spy_a, qqq_a, cash},
               ids, s0, s1, S, B, sums};
  if (B > 0 && S > 0)
    compose_kernel<<<(B + 31) / 32, NT, 0, (cudaStream_t)stream>>>(sp, ap, kc,
                                                                   a);
  return (int)cudaGetLastError();
}

extern "C" int letf_info_compose(int* out) {
  return letf_fill_info((const void*)compose_kernel, NT, 0, out);
}
