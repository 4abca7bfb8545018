// Kernel K1: joint SPY/QQQ/TLT returns + VIX + IRX. A block per 32 trials
// (lane = trial): three draw warps fill a shared-memory ring of day tiles,
// one recurrence warp runs the per-trial carry chain from it.
//
// Replaces letf_tpu/ops/pallas_joint.py::_joint_kernel (pallas_call at
// pallas_joint.py:399, entry pallas_joint_generate). Same math, day by day:
// six Box-Muller normals from the murmur3 counter RNG keyed by (seed words,
// base trial id, day, draw index 1..6); regime-conditional multivariate-t
// with the chi-square log-quantile Chebyshev; per-asset GARCH(1,1); DCC-lite
// Q; closed-form 3x3 Cholesky; VIX AR(1) with jumps; IRX. Day 0 keeps the
// reference's traced `firstf` blend form; the antithetic sign applies to the
// joint normals only; every parameter is the regime blend pa + pd * r. The
// plain PyTorch version is ops/joint.py::joint_plain. Layout [T, B], trials
// contiguous.
//
// What bounds it on the H100 (chip_smoke.py on an H100 80GB HBM3 at 700 W,
// 16,384 trials x 8,820 days; PERF.md holds the exploratory builds' split).
// Its bytes (one regime read, five outputs, 24 bytes a trial-day) take
// 1.035 ms at 3.35 TB/s; its chain of days takes far longer. The first port
// (one thread per trial, 32-thread blocks: ~4 warps an SM) took 18.0 ms, the
// same on 4,096 trials: each thread walked the whole day alone. Only the
// carry chain depends on yesterday, so here the draws leave it:
// - warp 0 runs the recurrence: it reads a ring tile back (the next day's
//   values ahead) and runs GARCH, DCC, Cholesky, x, z and VIX expression by
//   expression as before, storing x0, x1, x2 and VIX as 128-byte rows;
// - W = 3 draw warps compute, for day t = w (mod W) of each 12-day tile,
//   the six normals, the signed joint normals e0..e2, the chi-square scale
//   and the VIX normal into the ring (24 bytes a lane-day), and store IRX,
//   each loading its next regime row ahead. Where a strip's lanes 2k and
//   2k + 1 share an id (antithetic pairs), a pair-day's normals are computed
//   once;
// - each of the NSLOT = 2 ring slots has a FULL and an EMPTY named barrier
//   (bar.arrive by the side that hands over, bar.sync by the side that
//   waits), so the draw warps run up to two tiles ahead and no warp meets a
//   whole-block barrier in the day loop; a ragged last strip computes on
//   the last trial's inputs and stores nothing, meeting every barrier;
// - the recurrence alone still was a latency chain: each IEEE division (13
//   a day) and square root (12) is a branch to its slow path, and the
//   branches cut the chain into short blocks the scheduler cannot overlap.
//   FastMath (fastmath.cuh) computes them by the card's own fast sequences,
//   checks once a day that every input lay in the range where those are the
//   correctly rounded results, and recomputes the day by IEEE otherwise:
//   the same bits, about a third less time;
// - sinf/cosf are their library's fast path (sin_cos): a Box-Muller angle
//   never reaches the slow path, whose Payne-Hanek array took local memory.
// 128 threads and at most 128 registers keep 4 blocks (16 warps) an SM, so
// a 16,384-trial chunk (512 blocks) runs in one wave: ~6.5 ms, ~4.6 ms on
// 4,096 trials (one block an SM), so the recurrence's chain, and the draw
// warps' instructions on the same schedulers, set the time. Every value
// is the first port's bit for bit: chip_smoke.py holds its output digests,
// tests/test_torch_cuda.py holds FastMath and sin_cos to the operations
// they replace (letf_joint_math_check).

#include "fastmath.cuh"

namespace {

enum {
  MU0, MU1, MU2, LV0, LV1, LV2, ALPHA, BETA, DCC_A, DCC_B, NU,
  RB00, RB01, RB02, RB11, RB12, RB22,
  VPHI, VTGT, VNOISE, VJTHR, VJSCL, VBASE, DSTD, IRXB, NPARAM
};
constexpr int kMaxCheb = 32;
// One lane-day of the ring: what the recurrence reads of the draws.
enum { R_REG, R_E0, R_E1, R_E2, R_SCALE, R_VN, NRING };
constexpr int D = 12;             // days a ring tile holds
constexpr int W = 3;              // draw warps a block
constexpr int NSLOT = 2;          // ring tiles
constexpr int NT = 32 * (W + 1);  // threads a block
constexpr int MIN_BLOCKS = 4;     // resident blocks an SM
static_assert(D % (2 * W) == 0, "a draw warp takes its days two at a time");
static_assert(2 * NSLOT < 16, "FULL and EMPTY barriers fit the 16 ids");

// Per-regime tables: pa = row value in regime 0, pd = regime 1 - regime 0,
// and the Chebyshev coefficients ca, cd alike.
struct Tables {
  float pa[NPARAM], pd[NPARAM], ca[kMaxCheb], cd[kMaxCheb];
};

struct Shared {
  Tables tb;
  float ring[NSLOT][D][NRING][32];
  float pair[W][6][32];             // each draw warp's shared pair normals
};

// The parameters blended at regime r, as the reference's pa + pd * r.
struct Par {
  const Tables& tb;
  float r;
  __device__ __forceinline__ float operator()(int i) const {
    return tb.pa[i] + tb.pd[i] * r;
  }
  __device__ __forceinline__ float cheb(int k) const {
    return tb.ca[k] + tb.cd[k] * r;
  }
};

struct Args {
  const float* regime;
  const int* ids;
  const float* signs;
  uint32_t s0, s1;
  int T, B, n_cheb;
  float *x0, *x1, *x2, *vix, *irx;
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

// The six normals of a trial-day from its counter key.
template <class M>
__device__ __forceinline__ void six_normals(uint32_t dk, float* nrm, M& m) {
#pragma unroll
  for (int p = 0; p < 3; ++p) {
    const float u1 = letf_stream_unit(dk, 2 * p + 1);
    const float u2 = letf_stream_unit(dk, 2 * p + 2);
    const float rad = m.sqrt(-2.0f * logf(u1));
    float sn, cs;
    sin_cos(LETF_TWO_PI * u2, sn, cs);
    nrm[2 * p] = rad * cs;
    nrm[2 * p + 1] = rad * sn;
  }
}

// The rest of a trial-day's carry-free part, from its normals: out[R_*]
// and IRX.
template <class M>
__device__ __forceinline__ void finish_draws(const Tables& tb, int n_cheb,
                                             const float* nrm, float r,
                                             float sign, float* out,
                                             float& irx, M& m) {
  const Par g{tb, r};
  // chi-square(nu_r) by one Clenshaw pass over the regime-blended table.
  const float tc = jclip(nrm[3] * (float)(1.0 / 6.3), -1.0f, 1.0f);
  float b1 = 0.f, b2 = 0.f;
  for (int k = n_cheb - 1; k > 0; --k) {
    const float ck = g.cheb(k);
    const float nb1 = ck + 2.0f * tc * b1 - b2;
    b2 = b1;
    b1 = nb1;
  }
  const float c0k = g.cheb(0);
  const float u_chi = expf(c0k + tc * b1 - b2);
  out[R_REG] = r;
  out[R_E0] = nrm[0] * sign;
  out[R_E1] = nrm[1] * sign;
  out[R_E2] = nrm[2] * sign;
  out[R_SCALE] = m.sqrt(m.div(g(NU), jmax(u_chi, 1e-12f)));
  out[R_VN] = nrm[4];
  irx = jclip(g(IRXB) + 0.5f * nrm[5], 0.0f, 15.0f);
}

struct Carry {
  float h0 = 0.f, h1 = 0.f, h2 = 0.f;
  float q00 = 0.f, q01 = 0.f, q02 = 0.f, q11 = 0.f, q12 = 0.f, q22 = 0.f;
  float z0 = 0.f, z1 = 0.f, z2 = 0.f, prev_r = 0.f, vixp = 0.f;
};

// The carry chain of day t from its draws v[R_*]: x0, x1, x2 and VIX,
// dividing and taking square roots by m.
template <class M>
__device__ __forceinline__ void recur_day(const Tables& tb, Carry& c,
                                          bool first, const float* v,
                                          float* x, M& m) {
  const float r = v[R_REG];
  const Par g{tb, r};
  const float e0 = v[R_E0], e1 = v[R_E1], e2 = v[R_E2];
  const float scale = v[R_SCALE], vn = v[R_VN];
  const float firstf = first ? 1.0f : 0.0f;
  const float lv0 = g(LV0), lv1 = g(LV1), lv2 = g(LV2);
  const float rb00 = g(RB00), rb01 = g(RB01), rb02 = g(RB02);
  const float rb11 = g(RB11), rb12 = g(RB12), rb22 = g(RB22);
  const float sw = fabsf(r - c.prev_r) * (1.0f - firstf);

  const float alpha = g(ALPHA), beta = g(BETA);
  const float one_ab = 1.0f - alpha - beta;
  const float g0 = jmax(one_ab * lv0 + alpha * c.z0 * c.z0 * c.h0 + beta * c.h0, 1e-10f);
  const float g1 = jmax(one_ab * lv1 + alpha * c.z1 * c.z1 * c.h1 + beta * c.h1, 1e-10f);
  const float g2 = jmax(one_ab * lv2 + alpha * c.z2 * c.z2 * c.h2 + beta * c.h2, 1e-10f);
  auto sel3 = [&](float lv, float garch, float h) {
    const float blend = 0.10f * lv + 0.90f * h;
    const float v = garch + sw * (blend - garch);
    return lv * firstf + v * (1.0f - firstf);
  };
  const float h0n = sel3(lv0, g0, c.h0), h1n = sel3(lv1, g1, c.h1),
              h2n = sel3(lv2, g2, c.h2);

  const float ad = g(DCC_A), bd = g(DCC_B);
  const float one_abd = 1.0f - ad - bd;
  auto qsel = [&](float rb, float q, float zz) {
    const float dcc = one_abd * rb + ad * zz + bd * q;
    const float blend = 0.10f * rb + 0.90f * q;
    const float v = dcc + sw * (blend - dcc);
    return rb * firstf + v * (1.0f - firstf);
  };
  const float q00n = qsel(rb00, c.q00, c.z0 * c.z0);
  const float q01n = qsel(rb01, c.q01, c.z0 * c.z1);
  const float q02n = qsel(rb02, c.q02, c.z0 * c.z2);
  const float q11n = qsel(rb11, c.q11, c.z1 * c.z1);
  const float q12n = qsel(rb12, c.q12, c.z1 * c.z2);
  const float q22n = qsel(rb22, c.q22, c.z2 * c.z2);

  const float d0 = m.sqrt(jmax(q00n, 1e-12f));
  const float d1 = m.sqrt(jmax(q11n, 1e-12f));
  const float d2 = m.sqrt(jmax(q22n, 1e-12f));
  const float sa = m.sqrt(h0n), sb = m.sqrt(h1n), sc = m.sqrt(h2n);
  const float c00 = m.div(q00n, d0 * d0) * sa * sa;
  const float c01 = m.div(q01n, d0 * d1) * sa * sb;
  const float c02 = m.div(q02n, d0 * d2) * sa * sc;
  const float c11 = m.div(q11n, d1 * d1) * sb * sb;
  const float c12 = m.div(q12n, d1 * d2) * sb * sc;
  const float c22 = m.div(q22n, d2 * d2) * sc * sc;

  const float epsv = 1e-18f;
  const float l00 = m.sqrt(jmax(c00, epsv));
  const float l10 = m.div(c01, l00);
  const float l20 = m.div(c02, l00);
  const float l11 = m.sqrt(jmax(c11 - l10 * l10, epsv));
  const float l21 = m.div(c12 - l20 * l10, l11);
  const float l22 = m.sqrt(jmax(c22 - l20 * l20 - l21 * l21, epsv));
  const float zz0 = l00 * e0;
  const float zz1 = l10 * e0 + l11 * e1;
  const float zz2 = l20 * e0 + l21 * e1 + l22 * e2;

  const float mu0 = g(MU0), mu1 = g(MU1), mu2 = g(MU2);
  x[0] = jclip(mu0 + zz0 * scale, -0.95f, 4.0f);
  x[1] = jclip(mu1 + zz1 * scale, -0.95f, 4.0f);
  x[2] = jclip(mu2 + zz2 * scale, -0.95f, 4.0f);
  c.z0 = m.div(x[0] - mu0, m.sqrt(jmax(h0n, 1e-10f)));
  c.z1 = m.div(x[1] - mu1, m.sqrt(jmax(h1n, 1e-10f)));
  c.z2 = m.div(x[2] - mu2, m.sqrt(jmax(h2n, 1e-10f)));

  const float shock = m.div(jmax(-x[0], 0.0f), jmax(g(DSTD), 1e-4f));
  const float vjump = g(VJSCL) * jmax(shock - g(VJTHR), 0.0f);
  const float phi = g(VPHI);
  const float vix_ar = jmax(
      phi * c.vixp + (1.0f - phi) * g(VTGT) + vjump + g(VNOISE) * vn, 10.0f);
  x[3] = g(VBASE) * firstf + vix_ar * (1.0f - firstf);
  c.h0 = h0n; c.h1 = h1n; c.h2 = h2n;
  c.q00 = q00n; c.q01 = q01n; c.q02 = q02n;
  c.q11 = q11n; c.q12 = q12n; c.q22 = q22n;
  c.prev_r = r;
  c.vixp = x[3];
}

// One day of the recurrence by FastMath, and by IeeeMath again from the
// same carry if an input fell out of FastMath's range, so the bits are
// IeeeMath's either way.
__device__ __forceinline__ void recur_step(const Tables& tb, Carry& c,
                                           bool first, const float* v,
                                           float* x) {
  Carry n = c;
  FastMath fm;
  recur_day(tb, n, first, v, x, fm);
  if (!fm.ok) {
    n = c;
    IeeeMath im;
    recur_day(tb, n, first, v, x, im);
  }
  c = n;
}

// The draws of one trial-day from its normals, as recur_step.
__device__ __forceinline__ void finish_step(const Tables& tb, int n_cheb,
                                            const float* nrm, float r,
                                            float sign, float* out,
                                            float& irx) {
  FastMath fm;
  finish_draws(tb, n_cheb, nrm, r, sign, out, irx, fm);
  if (!fm.ok) {
    IeeeMath im;
    finish_draws(tb, n_cheb, nrm, r, sign, out, irx, im);
  }
}

// The six normals of a trial-day, as recur_step.
__device__ __forceinline__ void normals_step(uint32_t dk, float* nrm) {
  FastMath fm;
  six_normals(dk, nrm, fm);
  if (!fm.ok) {
    IeeeMath im;
    six_normals(dk, nrm, im);
  }
}

// The per-regime tables into shared memory, then one __syncthreads.
__device__ __forceinline__ void block_setup(Tables& tb, const float* params,
                                            const float* cheb, int n_cheb) {
  for (int i = threadIdx.x; i < NPARAM; i += blockDim.x) {
    tb.pa[i] = params[2 * i];
    tb.pd[i] = params[2 * i + 1] - params[2 * i];
  }
  for (int k = threadIdx.x; k < n_cheb; k += blockDim.x) {
    tb.ca[k] = cheb[k];
    tb.cd[k] = cheb[n_cheb + k] - cheb[k];
  }
  __syncthreads();
}

// Draw warp w of W: days t = w (mod W) of every tile into the ring. A
// strip whose lanes 2k and 2k + 1 share their id (the antithetic pairs of
// production, ids = rows // 2) computes the normals of a pair-day once:
// the warp takes two of its days at a time, lanes 0-15 the first day's 16
// pairs and lanes 16-31 the second's, and every lane reads its pair's
// normals back from the warp's rows in shared memory. Any other strip
// computes each lane's own.
__device__ __forceinline__ void draw_role(Shared& sh, const Args& a, int w,
                                          int lane, int b, int bc,
                                          int ntile) {
  const float sign = a.signs[bc];
  const bool pairs =
      __all_sync(0xffffffffu, a.ids[bc] == a.ids[min(b ^ 1, a.B - 1)]);
  const int step = pairs ? 2 * W : W;
  // Whose normals this lane computes, and on which of the two days.
  const int lead = pairs ? min(b - lane + 2 * (lane & 15), a.B - 1) : bc;
  const uint32_t key = letf_lane_key(a.ids[lead], a.s0);
  const int shift = pairs ? (lane >> 4) * W : 0;
  float (*pn)[32] = sh.pair[w];
  float r_next[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = w + h * W;
    r_next[h] = t < a.T ? a.regime[(size_t)t * a.B + bc] : 0.0f;
  }
  for (int k = 0; k < ntile; ++k) {
    const int s = k % NSLOT;
    if (k >= NSLOT) bar_sync(empty_bar(s));
#pragma unroll 1
    for (int j = w; j < D; j += step) {
      const int t = k * D + j;
      if (t >= a.T) break;
      float nrm[6];
      normals_step(letf_day_key(key, (uint32_t)(t + shift), a.s1), nrm);
      if (pairs) {
#pragma unroll
        for (int f = 0; f < 6; ++f) pn[f][lane] = nrm[f];
        __syncwarp();
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h == 1 && !pairs) break;
        const int th = t + h * W;
        const float r = r_next[h];
        if (th + step < a.T)
          r_next[h] = a.regime[(size_t)(th + step) * a.B + bc];
        if (th >= a.T) break;
        if (pairs) {
#pragma unroll
          for (int f = 0; f < 6; ++f) nrm[f] = pn[f][16 * h + (lane >> 1)];
        }
        float v[NRING], irx;
        finish_step(sh.tb, a.n_cheb, nrm, r, sign, v, irx);
#pragma unroll
        for (int f = 0; f < NRING; ++f) sh.ring[s][j + h * W][f][lane] = v[f];
        if (b < a.B) a.irx[(size_t)th * a.B + b] = irx;
      }
      if (pairs) __syncwarp();
    }
    bar_arrive(full_bar(s));
  }
}

// The recurrence warp: every tile of the ring in order.
__device__ __forceinline__ void recurrence_role(Shared& sh, const Args& a,
                                                int lane, int b, int ntile) {
  Carry c;
  for (int k = 0; k < ntile; ++k) {
    const int s = k % NSLOT;
    bar_sync(full_bar(s));
    const int nd = min(D, a.T - k * D);
    float nxt[NRING];
#pragma unroll
    for (int f = 0; f < NRING; ++f) nxt[f] = sh.ring[s][0][f][lane];
#pragma unroll 1
    for (int j = 0; j < nd; ++j) {
      const int t = k * D + j;
      float v[NRING], x[4];
#pragma unroll
      for (int f = 0; f < NRING; ++f) v[f] = nxt[f];
      if (j + 1 < nd) {
#pragma unroll
        for (int f = 0; f < NRING; ++f) nxt[f] = sh.ring[s][j + 1][f][lane];
      }
      recur_step(sh.tb, c, t == 0, v, x);
      if (b < a.B) {
        const size_t at = (size_t)t * a.B + b;
        a.x0[at] = x[0];
        a.x1[at] = x[1];
        a.x2[at] = x[2];
        a.vix[at] = x[3];
      }
    }
    // The draw warps wait on this slot only for the tile NSLOT ahead.
    if (k + NSLOT < ntile) bar_arrive(empty_bar(s));
  }
}

// Warp 0 runs the recurrence, warps 1..W the draws.
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
joint_kernel(Args a, const float* __restrict__ params,
             const float* __restrict__ cheb) {
  __shared__ Shared sh;
  block_setup(sh.tb, params, cheb, a.n_cheb);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // Lanes past B (the ragged last strip) run on the last trial's inputs
  // and store nothing, so every warp meets every barrier.
  const int b = blockIdx.x * 32 + lane;
  const int bc = b < a.B ? b : a.B - 1;
  const int ntile = (a.T + D - 1) / D;
  if (warp == 0)
    recurrence_role(sh, a, lane, b, ntile);
  else
    draw_role(sh, a, warp - 1, lane, b, bc, ntile);
}

// FastMath and sin_cos beside the operations whose bits they stand for,
// one element a thread: out rows [10, n] hold FastMath a / b, a / b, its
// range flag (1 or 0), FastMath sqrt(a), sqrtf(a), its flag, then the sine
// of sin_cos(a), sinf(a), its cosine and cosf(a).
__global__ void math_check_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b, int n,
                                  float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float x = a[i], y = b[i];
  const size_t m = n;
  FastMath fd, fs;
  out[i] = fd.div(x, y);
  out[m + i] = x / y;
  out[2 * m + i] = fd.ok ? 1.0f : 0.0f;
  out[3 * m + i] = fs.sqrt(x);
  out[4 * m + i] = sqrtf(x);
  out[5 * m + i] = fs.ok ? 1.0f : 0.0f;
  float sn, cs;
  sin_cos(x, sn, cs);
  out[6 * m + i] = sn;
  out[7 * m + i] = sinf(x);
  out[8 * m + i] = cs;
  out[9 * m + i] = cosf(x);
}

}  // namespace

extern "C" int letf_joint(const float* params, const float* cheb, int n_cheb,
                          const float* regime, const int* ids,
                          const float* signs, unsigned int s0,
                          unsigned int s1, int T, int B, float* x0,
                          float* x1, float* x2, float* vix, float* irx,
                          void* stream) {
  const Args a{regime, ids, signs, s0, s1, T, B, n_cheb, x0, x1, x2, vix, irx};
  if (B > 0 && T > 0 && n_cheb > 0 && n_cheb <= kMaxCheb)
    joint_kernel<<<(B + 31) / 32, NT, 0, (cudaStream_t)stream>>>(a, params,
                                                                 cheb);
  return (int)cudaGetLastError();
}

extern "C" int letf_joint_math_check(const float* a, const float* b, int n,
                                     float* out, void* stream) {
  if (n > 0)
    math_check_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
        a, b, n, out);
  return (int)cudaGetLastError();
}

extern "C" const char* letf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int letf_info_joint(int* out) {
  return letf_fill_info((const void*)joint_kernel, NT, 0, out);
}
