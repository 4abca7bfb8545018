// The emitting day kernel: the sequential part of the emitting strategy
// engine (strategies/engine.py::run_strategies_batch with emit_trades).
//
// Replaces no Pallas kernel: the JAX package runs the emitting path as one
// XLA scan over days (letf_tpu/strategies/engine.py:602, the step at :213).
// The port's first version is the torch day loop that stays as the CPU twin
// (ops/emit_days.py::emit_days_plain): S19's thresholded allocation, then
// the equities of the 19 strategies with the cashflow overlay, the ruin
// floor, S6's two sleeves (21-day rebalance, embedded-leverage turnover),
// the running maxima and drawdowns and the journal's pre-day equities.
// Each day there is ~30 small torch launches over [19, B] or [B]: 227k
// launches at 7,560 days, the host's pace, whatever B is.
//
// What bounds it on the H100: bytes. The inputs are the strategies' day
// returns ret_all [S, 19, B] and six [S, B] channels (S19's candidate
// allocation, TQQQ's and TMF's returns, cash, S6's two embedded
// leverages), the outputs the journal's equities value [S, 13, B] and
// S19's trade flags [S, B]: ~1.1 KB a trial-day read or written once,
// 0.23 ms at [7,560, 650] and 5.6 ms at [7,560, 16,384] at 3.35 TB/s. The
// work is ~25 float operations a strategy-day. No strategy reads another's
// carries, so a thread owns one (trial, strategy): blockIdx.y is the
// strategy, neighbouring threads hold neighbouring trials, and every day's
// loads and journal stores coalesce. A thread's chain is its strategy's
// recurrence alone (a multiply, an add, a max and a select a day on the
// equity; S6's two divisions on its sleeves), and 19 chains a trial give
// the few trials of a sampled replay (B <= 650) enough warps. The loads
// of a chunk of days go out together before the chunk's chain runs, which
// hides most of a memory latency a day; a chunk is 21 days, so it starts on
// S6's rebalance days and S6 reads its embedded leverages once a chunk.
//
// Every output is bitwise the twin's on the card (tests/
// test_torch_emit_days_cuda.py): the same operations in the same order,
// with the library built by ops/_build.py (-fmad=false, IEEE division,
// no fast math) as torch's one-operation kernels round; torch's maximum
// and clamp_min propagate NaN (jmax), fmaxf alone would not; torch's
// division by a Python scalar is a multiplication by its float reciprocal
// on CUDA (S6's leverage turnover: inv_lev); 1.0 / x is x.reciprocal().

#include "common.cuh"

namespace {

constexpr int kThreads = 64;
constexpr int kNS = 19;        // strategies
constexpr int kNTax = 13;      // journal columns: S7..S19
constexpr int kTax0 = 6;       // the first taxable strategy (S7)
constexpr int kS6 = 5;
constexpr int kS19 = 18;
constexpr int kRebalance = 21; // S6's rebalance period in days
constexpr int kChunk = kRebalance;
constexpr float kFltMin = 1.17549435082228750797e-38f;

struct Args {
  const float* ret;     // [S, NS, B]; S6's and S19's slots are not read
  const float* cand19;  // [S, B] S19's candidate allocation
  const float* rq;      // [S, B] TQQQ's return
  const float* rm;      // [S, B] TMF's return
  const float* cash;    // [S, B]
  const float* emb0;    // [S, B] S6's embedded leverage of TQQQ
  const float* emb1;    // [S, B] and of TMF
  const float* cf;      // [S] cashflows, or null
  float* eq;            // [NS, B] final equity
  float* mdd;           // [NS, B] max drawdown
  float* value;         // [S, NTax, B] equity before each day
  uint8_t* traded19;    // [S, B] S19 traded
  int S, B, apply_costs;
  // engine.py's constants in float32: initial capital, S6's initial
  // sleeves, weights, leverages and their reciprocals; the rebalance cost
  // per dollar; the vol family's spread.
  float capital, sleeve0, sleeve1, w0, w1, lev0, lev1, inv_lev0, inv_lev1,
      rcpd, spread;
};

struct Carry {
  float eq, run_max, mdd;
};

// Days [t0, t0 + kChunk) of trial b's column p (a day is `day` floats
// apart), 0 past S.
__device__ __forceinline__ void load_days(float (&v)[kChunk],
                                          const float* __restrict__ p,
                                          size_t day, int t0, int S) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    v[u] = t0 + u < S ? __ldg(p + (size_t)(t0 + u) * day) : 0.0f;
}

__device__ __forceinline__ void load_cf(float (&v)[kChunk],
                                        const float* __restrict__ cf, int t0,
                                        int S) {
#pragma unroll
  for (int u = 0; u < kChunk; ++u)
    v[u] = cf != nullptr && t0 + u < S ? __ldg(cf + t0 + u) : 0.0f;
}

// The loop's close of day t for one strategy: the cashflow overlay,
// clamp_min(0), the ruin floor; the running max (day 0's equity on day 0)
// and the max drawdown. Returns the equity after the day.
__device__ __forceinline__ float close_day(Carry& c, float eq_new, float cf,
                                           int t) {
  const float e = jmax(eq_new + cf, 0.0f);
  const float eq_cf = e < kFltMin ? 0.0f : e;
  c.run_max = t == 0 ? eq_cf : jmax(c.run_max, eq_cf);
  const float dd = (eq_cf - c.run_max) / (c.run_max > 0.0f ? c.run_max : 1.0f);
  c.mdd = jmax(c.mdd, -dd);
  c.eq = eq_cf;
  return eq_cf;
}

// Strategy s (not S6, not S19): eq *= 1 + ret; every return of S4..S18 is
// 0 on day 0 (the benchmarks S1-S3 compound day 0).
__device__ __forceinline__ void plain_days(const Args& a, int s, int b) {
  const size_t B = a.B;
  const float* ret = a.ret + (size_t)s * B + b;
  float* value = s >= kTax0 ? a.value + (size_t)(s - kTax0) * B + b : nullptr;
  Carry c{a.capital, a.capital, 0.0f};
  for (int t0 = 0; t0 < a.S; t0 += kChunk) {
    float r[kChunk], cf[kChunk];
    load_days(r, ret, (size_t)kNS * B, t0, a.S);
    load_cf(cf, a.cf, t0, a.S);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (t < a.S) {
        if (value != nullptr) value[(size_t)t * kNTax * B] = c.eq;
        const float rt = t == 0 && s >= 3 ? 0.0f : r[u];
        close_day(c, c.eq * (1.0f + rt), cf[u], t);
      }
    }
  }
  a.eq[s * B + b] = c.eq;
  a.mdd[s * B + b] = c.mdd;
}

// S6 60/40 TQQQ/TMF: the sleeves grow by their returns; on every 21st day
// (not day 0) they rebalance to the weights at a cost on the weight and
// embedded-leverage turnover; the strategy's equity is their sum, and the
// overlay and floor scale both sleeves.
__device__ __forceinline__ void s6_days(const Args& a, int b) {
  const size_t B = a.B;
  float s0 = a.sleeve0, s1 = a.sleeve1;
  Carry c{a.capital, a.capital, 0.0f};
  for (int t0 = 0; t0 < a.S; t0 += kChunk) {
    float rq[kChunk], rm[kChunk], cf[kChunk];
    load_days(rq, a.rq + b, B, t0, a.S);
    load_days(rm, a.rm + b, B, t0, a.S);
    load_cf(cf, a.cf, t0, a.S);
    // A chunk starts on a rebalance day.
    const bool rebalance = t0 > 0;
    const float e0 = rebalance ? __ldg(a.emb0 + (size_t)t0 * B + b) : 0.0f;
    const float e1 = rebalance ? __ldg(a.emb1 + (size_t)t0 * B + b) : 0.0f;
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (t < a.S) {
        float g0 = s0 * (1.0f + rq[u]), g1 = s1 * (1.0f + rm[u]);
        const float total6 = g0 + g1;
        float after = total6;
        if (u == 0 && rebalance) {
          const float inv_t6 = 1.0f / jmax(total6, 1e-30f);
          const float cw0 = g0 * inv_t6, cw1 = g1 * inv_t6;
          const float w_turn = fabsf(cw0 - a.w0) + fabsf(cw1 - a.w1);
          const float lev_turn = fabsf(e0 - a.lev0) * a.inv_lev0 * cw0 +
                                 fabsf(e1 - a.lev1) * a.inv_lev1 * cw1;
          const float tot_turn = w_turn + lev_turn;
          if (a.apply_costs && tot_turn > 0.01f)
            after = total6 * (1.0f - tot_turn * a.rcpd);
          g0 = after * a.w0;
          g1 = after * a.w1;
        }
        if (t == 0) {
          g0 = s0;
          g1 = s1;
          after = c.eq;
        }
        const float eq_cf = close_day(c, after, cf[u], t);
        const float scale = eq_cf / jmax(after, 1e-30f);
        s0 = g0 * scale;
        s1 = g1 * scale;
      }
    }
  }
  a.eq[kS6 * B + b] = c.eq;
  a.mdd[kS6 * B + b] = c.mdd;
}

// S19 conviction compounder: the carried allocation moves to the day's
// candidate when they differ by more than 5% (the carry keeps day 0's
// move out), the return is the allocation's mix of TQQQ and cash less the
// spread on the move; its trade flags go out for the epilogue's counts.
__device__ __forceinline__ void s19_days(const Args& a, int b) {
  const size_t B = a.B;
  float* value = a.value + (size_t)(kS19 - kTax0) * B + b;
  float a19 = 0.0f;
  Carry c{a.capital, a.capital, 0.0f};
  for (int t0 = 0; t0 < a.S; t0 += kChunk) {
    float cand[kChunk], rq[kChunk], cash[kChunk], cf[kChunk];
    load_days(cand, a.cand19 + b, B, t0, a.S);
    load_days(rq, a.rq + b, B, t0, a.S);
    load_days(cash, a.cash + b, B, t0, a.S);
    load_cf(cf, a.cf, t0, a.S);
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int t = t0 + u;
      if (t < a.S) {
        value[(size_t)t * kNTax * B] = c.eq;
        const float turn = fabsf(cand[u] - a19);
        const bool traded = turn > 0.05f;
        const float alloc = traded ? cand[u] : a19;
        float r19 = alloc * rq[u] + (1.0f - alloc) * cash[u];
        if (a.apply_costs) r19 = r19 - (traded ? turn * a.spread : 0.0f);
        if (t > 0) a19 = alloc;
        a.traded19[(size_t)t * B + b] = traded;
        close_day(c, c.eq * (1.0f + (t == 0 ? 0.0f : r19)), cf[u], t);
      }
    }
  }
  a.eq[kS19 * B + b] = c.eq;
  a.mdd[kS19 * B + b] = c.mdd;
}

__global__ void __launch_bounds__(kThreads) emit_days_kernel(const Args a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.B) return;
  const int s = blockIdx.y;
  if (s == kS6)
    s6_days(a, b);
  else if (s == kS19)
    s19_days(a, b);
  else
    plain_days(a, s, b);
}

}  // namespace

// in: a HOST array of the 8 input pointers (ret, cand19, rq, rm, cash,
// emb0, emb1, cf; cf may be null); kc: a HOST array of Args' 11 constants
// in their order.
extern "C" int letf_emit_days(const float* const* in, const float* kc, int S,
                              int B, int apply_costs, float* eq, float* mdd,
                              float* value, unsigned char* traded19,
                              void* stream) {
  if (B > 0 && S > 0) {
    const Args a{in[0], in[1], in[2], in[3], in[4], in[5], in[6], in[7],
                 eq, mdd, value, traded19, S, B, apply_costs,
                 kc[0], kc[1], kc[2], kc[3], kc[4], kc[5], kc[6], kc[7],
                 kc[8], kc[9], kc[10]};
    const dim3 grid((B + kThreads - 1) / kThreads, kNS);
    emit_days_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}

extern "C" int letf_info_emit_days(int* out) {
  return letf_fill_info((const void*)emit_days_kernel, kThreads, 0, out);
}
