// Kernel K5: stress + crisis jumps + funding spread + leverage/expense/
// financing + AR(1) tracking error for all six assets, one thread per
// trial, one pass over the window's days.
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
// What bounds it on the H100: a serial per-trial day recurrence (~14
// transcendentals and ~400 flops a day) at one warp per 32 trials, so it is
// latency-bound like K3; its 15 [S, B] planes (6 in, 9 out) coalesce across
// a warp and move ~7 GB at 16,384 trials x 30 years, a few ms of the
// card's bandwidth. The stress/asset tables sit in shared memory.

#include "compose_day.cuh"

namespace {

using namespace compose_day;

// Constants table (ops/compose.py::kernel_consts).
enum { K_EMA, K_ONE_M_EMA, K_UND, K_DF = K_UND + NA, K_M2DF = K_DF + NA,
       NK = K_M2DF + NA };

struct Tables {
  float spa[NSP], spd[NSP], ap[NAP * NA], k[NK];
};

struct Io {
  const float *spy, *qqq, *tlt, *vix, *irx, *regime;
  float *etf, *spy_a, *qqq_a, *cash;
};

template <bool FIRST>
__device__ __forceinline__ void day(const Tables& T, const Io& io, int t,
                                    int S, int B, int b, uint32_t dk,
                                    float& liq, float& cred, float* te,
                                    float* bias, float& jc, float& ls,
                                    float& cs) {
  const size_t at = (size_t)t * B + b;
  const float reg = io.regime[at];
  const float tlt_w = io.tlt[at];
  const DayStress ds = stress_day<FIRST>(T.spa, T.spd, dk, liq, cred,
                                         io.spy[at], io.qqq[at], io.vix[at],
                                         io.irx[at], reg);
  jc = jc + ds.jump_on;
  ls = ls + ds.liq_n;
  cs = cs + ds.cred_n;
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    const int ui = (int)T.k[K_UND + a];
    const float src = ui == 0 ? ds.spy_a : (ui == 1 ? ds.qqq_a : tlt_w);
    const float e = asset_day<FIRST>(T.ap, a, src, ds, dk, T.k[K_DF + a],
                                     T.k[K_M2DF + a], T.k[K_EMA],
                                     T.k[K_ONE_M_EMA], te[a], bias[a]);
    io.etf[((size_t)a * S + t) * B + b] = jclip(e, -0.999f, 10.0f);
  }
  io.spy_a[at] = ds.spy_a;
  io.qqq_a[at] = ds.qqq_a;
  io.cash[at] = g2(T.spa, T.spd, CASH_RATE, reg) / 252.0f;
}

__global__ void __launch_bounds__(32)
compose_kernel(const float* __restrict__ sp, const float* __restrict__ ap,
               const float* __restrict__ kc, const int* __restrict__ ids,
               uint32_t s0, uint32_t s1, Io io, int S, int B,
               float* __restrict__ sums) {
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

  const uint32_t lane_key = letf_lane_key(ids[b], s0);
  float liq = 0.0f, cred = 0.0f, jc = 0.0f, ls = 0.0f, cs = 0.0f;
  float te[NA], bias[NA];
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    te[a] = 0.0f;
    bias[a] = 0.0f;
  }
  for (int t = 0; t < S; ++t) {
    const uint32_t dk = letf_day_key(lane_key, (uint32_t)t, s1);
    if (t == 0)
      day<true>(tb, io, t, S, B, b, dk, liq, cred, te, bias, jc, ls, cs);
    else
      day<false>(tb, io, t, S, B, b, dk, liq, cred, te, bias, jc, ls, cs);
  }
  sums[b] = jc;
  sums[(size_t)B + b] = ls;
  sums[2 * (size_t)B + b] = cs;
}

}  // namespace

extern "C" int letf_compose(const float* sp, const float* ap, const float* kc,
                            const int* ids, unsigned int s0, unsigned int s1,
                            const float* spy, const float* qqq,
                            const float* tlt, const float* vix,
                            const float* irx, const float* regime, int S,
                            int B, float* etf, float* spy_a, float* qqq_a,
                            float* cash, float* sums, void* stream) {
  const Io io{spy, qqq, tlt, vix, irx, regime, etf, spy_a, qqq_a, cash};
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  if (B > 0 && S > 0) {
    compose_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        sp, ap, kc, ids, s0, s1, io, S, B, sums);
  }
  return (int)cudaGetLastError();
}

extern "C" int letf_info_compose(int* out) {
  return letf_fill_info((const void*)compose_kernel, 32, 0, out);
}
