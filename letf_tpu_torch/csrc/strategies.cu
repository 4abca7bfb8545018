// Kernel K4: the 19 strategies over precomputed channels.
//
// Replaces letf_tpu/ops/pallas_strategies.py::_strategy_kernel in its
// channel modes (pallas_call at pallas_strategies.py:1081, entry
// pallas_strategies_run), both of them:
// - channel mode (the main path's): 23 [S, B] channels in CHANNELS order
//   (r_tqqq, r_spy, r_sso, r_tmf, cash, regime, vix, then the 16 signals
//   spy_price .. rsi14); the strategies read the signals at shift(1), i.e.
//   yesterday's channel values carried in registers, and S7 today's;
// - fused-signals mode: only the first 7 channels; the 16 signals are
//   computed in the kernel from ring buffers (the same signals_read /
//   signals_step as kernel K3).
// The day math is strategies_day.cuh, shared with K3, so the strategies'
// arithmetic is one copy. spy_price is a channel in channel mode (not
// compounded here), as in the reference, so SMA compares see the same bits
// as the signal pass that made it. The flush-to-zero ruin floor is kept.
// The plain PyTorch version is ops/strategies.py::strategies_plain.
//
// What bounds it on the H100 (chip_smoke.py and PERF.md's exploratory
// split, an H100 80GB HBM3 at 700 W, 16,384 trials x 7,560 days). Channel
// mode reads 23 floats a trial-day (11.4 GB: 3.4 ms at 3.35 TB/s) and
// writes only the 57 summary rows. Its work is a serial day recurrence:
// ~1,880 SASS instructions a day (44 divisions, 3 powf) over ~130 floats
// of strategy state. The first port ran it on one thread per trial (233
// registers, 32-thread blocks: ~4 warps an SM, one chain per scheduler) in
// 38.4 ms, and as long on 4,096 trials: one chain's latency set the time.
// Here, in channel mode:
// - a block owns 32 trials (one a lane) and each of its 4 warps runs one
//   strategy group over them (strategies_day.cuh's split: no strategy reads
//   another's carries), keeping only that group's carries and shift(1)
//   signals and loading only the channels its strategies read, straight
//   from global memory (coalesced across the lanes), the next day's while
//   the day computes. Four chains a trial, each about a quarter of the day
//   (352-460 instructions), 16 warps an SM at 111 registers;
// - each group's divisions run by FastMath (fastmath.cuh: the compiler's
//   fast sequences without their slow-path branches, which cut the chain),
//   and a day whose operands fell out of FastMath's range is recomputed by
//   IEEE from the saved carries (group_day), so the bits are the first
//   port's;
// - the channel pointers are launch arguments: in the parameter bank they
//   hold no registers (read from a table in memory they took 122
//   registers, and 128 with a spill once the next day loaded ahead).
// The split alone took 38.4 ms to 17.0, FastMath to ~14.8. Staging the
// channels in a block-wide cp.async ring (one barrier a tile) was slower,
// 16.3-16.7 (the barrier ties each group to the slowest), and per-lane
// staging no faster. What is left is each group's chain: 12.8 ms on 4,096
// trials (one block an SM), 14.9 on 16,384.
// Fused-signals mode runs on no main path and keeps the one-thread body
// (strategies_step: the four groups in turn, each by group_day). Both modes
// take any trial count B. chip_smoke.py holds both bitwise to the first
// port's output digests.

#include "strategies_day.cuh"

namespace {

using namespace strategies_day;

constexpr int NCH = 23;
constexpr int NFUSED = 7;
constexpr int THREADS = 32 * NGROUP;    // 128: a warp a strategy group
constexpr int MIN_BLOCKS = 4;           // resident blocks an SM

// Launch arguments by value: the channel pointers sit in the parameter
// bank, so a load's address is one multiply-add and holds no register.
struct Args {
  const float* ch[NCH];   // NFUSED of them in fused-signals mode
  const float* cf;        // [S] or null
  float* rings;           // fused-signals mode's [RING_ROWS, B] scratch
  int S, B;
  float* out;
};

// Day t's channels and cashflow for trial column bc.
__device__ __forceinline__ void load_day(const Args& a, int t, int bc,
                                         float* v, float& cft) {
  const size_t at = (size_t)t * a.B + bc;
#pragma unroll
  for (int c = 0; c < NCH; ++c) v[c] = a.ch[c][at];
  cft = a.cf != nullptr ? __ldg(a.cf + t) : 0.0f;
}

// Group G's strategies over the block's 32 trials, day by day, the next
// day's channels loading while the day computes. The channels group G
// does not read are dead loads and go. Lanes past B run on the last
// trial's channels and store nothing.
template <int G, bool COSTS>
__device__ __forceinline__ void group_role(const float* K, const Args& a,
                                           int b) {
  const int bc = b < a.B ? b : a.B - 1;
  StratState st;
  init_strategies(st, K);
  float v[NCH], cft;
  load_day(a, 0, bc, v, cft);
  for (int t = 0; t < a.S; ++t) {
    float nv[NCH], ncft = 0.0f;
    if (t + 1 < a.S) load_day(a, t + 1, bc, nv, ncft);
    const DayCtx c = day_ctx(st, K, COSTS, t, v[0], v[1], v[2], v[3], v[4],
                             v[5], v[6], v + 7, cft);
    if (t == 0)
      group_day<G, true>(st, c);
    else
      group_day<G, false>(st, c);
    roll(st, v[6], v + 7);
#pragma unroll
    for (int i = 0; i < NCH; ++i) v[i] = nv[i];
    cft = ncft;
  }
  if (b < a.B) {
#pragma unroll
    for (int i = 0; i < NS; ++i)
      if (group_of(i) == G) store_strategy(st, i, a.out, b, a.B);
  }
}

template <bool COSTS>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
strategies_kernel(const Args a, const float* __restrict__ kc) {
  __shared__ float K[NK_STRAT];
  for (int i = threadIdx.x; i < NK_STRAT; i += THREADS) K[i] = kc[i];
  __syncthreads();
  const int b = blockIdx.x * 32 + (threadIdx.x & 31);
  switch (threadIdx.x >> 5) {
    case 0: group_role<0, COSTS>(K, a, b); break;
    case 1: group_role<1, COSTS>(K, a, b); break;
    case 2: group_role<2, COSTS>(K, a, b); break;
    default: group_role<3, COSTS>(K, a, b); break;
  }
}

// Fused-signals mode: one thread per trial, the signal rings in global
// scratch, the four groups in turn.
__global__ void __launch_bounds__(32)
strategies_fused_kernel(const Args a, const float* __restrict__ kc,
                        int apply_costs) {
  __shared__ float K[NK_STRAT];
  for (int i = threadIdx.x; i < NK_STRAT; i += blockDim.x) K[i] = kc[i];
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.B) return;

  const Rings rg{a.rings, b, a.B};
  StratState st;
  init_strategies(st, K);
  float sum[NSUM];
  init_signals(sum, rg);
  const bool costs = apply_costs != 0;

  for (int t = 0; t < a.S; ++t) {
    const size_t at = (size_t)t * a.B + b;
    const float r_tqqq = a.ch[0][at], r_spy = a.ch[1][at];
    const float r_sso = a.ch[2][at], r_tmf = a.ch[3][at];
    const float cashr = a.ch[4][at], reg = a.ch[5][at], vix = a.ch[6][at];
    const float cft = a.cf != nullptr ? a.cf[t] : 0.0f;
    float cur[NSIG];
    const RingIn rin = signals_read(rg, t);
    if (t == 0) {
      signals_step<true>(sum, rg, t, st.psig[G_PRICE], r_tqqq, r_spy, rin,
                         cur);
      strategies_step<true>(st, K, costs, t, r_tqqq, r_spy, r_sso, r_tmf,
                            cashr, reg, vix, cur, cft);
    } else {
      signals_step<false>(sum, rg, t, st.psig[G_PRICE], r_tqqq, r_spy, rin,
                          cur);
      strategies_step<false>(st, K, costs, t, r_tqqq, r_spy, r_sso, r_tmf,
                             cashr, reg, vix, cur, cft);
    }
  }
  store_summary(st, a.out, b, a.B);
}

}  // namespace

// Registers, shared memory and resident blocks of the kernel in its
// channel (fused = 0, with costs) or fused-signals mode at its launch
// shape.
extern "C" int letf_info_strategies(int fused, int* out) {
  return fused ? letf_fill_info((const void*)strategies_fused_kernel, 32, 0,
                                out)
               : letf_fill_info((const void*)strategies_kernel<true>,
                                THREADS, 0, out);
}

// chans: a HOST array of the channel pointers (23, or 7 when fused);
// rings [RING_ROWS, B] scratch (fused only); out [57, B].
extern "C" int letf_strategies(const float* cf, const float* kc,
                               const float* const* chans, float* rings,
                               int S, int B, int apply_costs, int has_cf,
                               int fused, float* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = (B + 31) / 32;
  if (B > 0 && S > 0) {
    Args a{};
    for (int c = 0; c < (fused ? NFUSED : NCH); ++c) a.ch[c] = chans[c];
    a.cf = has_cf ? cf : nullptr;
    a.rings = rings;
    a.S = S;
    a.B = B;
    a.out = out;
    if (fused)
      strategies_fused_kernel<<<blocks, 32, 0, st>>>(a, kc, apply_costs);
    else if (apply_costs)
      strategies_kernel<true><<<blocks, THREADS, 0, st>>>(a, kc);
    else
      strategies_kernel<false><<<blocks, THREADS, 0, st>>>(a, kc);
  }
  return (int)cudaGetLastError();
}
