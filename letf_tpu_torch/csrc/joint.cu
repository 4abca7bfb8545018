// Kernel K1: joint SPY/QQQ/TLT returns + VIX + IRX, one thread per trial.
//
// Replaces letf_tpu/ops/pallas_joint.py::_joint_kernel (pallas_call at
// pallas_joint.py:399, entry pallas_joint_generate). Same math, day by day:
// six Box-Muller normals from the murmur3 counter RNG keyed by (seed words,
// base trial id, day, draw index 1..6); regime-conditional multivariate-t
// with the chi-square log-quantile Chebyshev; per-asset GARCH(1,1); DCC-lite
// Q; closed-form 3x3 Cholesky; VIX AR(1) with jumps; IRX. Day 0 keeps the
// reference's traced `firstf` blend form; the antithetic sign applies to the
// joint normals only. The plain PyTorch version is ops/joint.py::joint_plain.
//
// Layout [T, B], trials contiguous: each day's regime load and five output
// stores coalesce across a warp. The 14-value carry lives in registers.
//
// What bounds it on the H100: a serial per-trial recurrence of ~400 flops a
// day with 7 transcendentals; at B = 16,384 trials there are only ~4 warps
// per SM, so it is latency-bound, not bandwidth-bound (it writes 20 bytes a
// trial-day). The design keeps every per-day value in registers and reads
// the parameter tables from shared memory; overlapping independent work
// (more trials in flight, or splitting the draw pass from the recurrence)
// is left to later work.

#include "common.cuh"

namespace {

enum {
  MU0, MU1, MU2, LV0, LV1, LV2, ALPHA, BETA, DCC_A, DCC_B, NU,
  RB00, RB01, RB02, RB11, RB12, RB22,
  VPHI, VTGT, VNOISE, VJTHR, VJSCL, VBASE, DSTD, IRXB, NPARAM
};
constexpr int kMaxCheb = 32;

__global__ void joint_kernel(const float* __restrict__ params,
                             const float* __restrict__ cheb, int n_cheb,
                             const float* __restrict__ regime,
                             const int* __restrict__ ids,
                             const float* __restrict__ signs,
                             uint32_t s0, uint32_t s1, int T, int B,
                             float* __restrict__ x0o, float* __restrict__ x1o,
                             float* __restrict__ x2o,
                             float* __restrict__ vixo,
                             float* __restrict__ irxo) {
  // Per-regime tables: pa = row value in regime 0, pd = regime 1 - regime 0.
  __shared__ float pa[NPARAM], pd[NPARAM], ca[kMaxCheb], cd[kMaxCheb];
  for (int i = threadIdx.x; i < NPARAM; i += blockDim.x) {
    pa[i] = params[2 * i];
    pd[i] = params[2 * i + 1] - params[2 * i];
  }
  for (int k = threadIdx.x; k < n_cheb; k += blockDim.x) {
    ca[k] = cheb[k];
    cd[k] = cheb[n_cheb + k] - cheb[k];
  }
  __syncthreads();
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  const uint32_t lane_key = letf_lane_key(ids[b], s0);
  const float sign = signs[b];
  float h0 = 0.f, h1 = 0.f, h2 = 0.f;
  float q00 = 0.f, q01 = 0.f, q02 = 0.f, q11 = 0.f, q12 = 0.f, q22 = 0.f;
  float z0 = 0.f, z1 = 0.f, z2 = 0.f, prev_r = 0.f, vixp = 0.f;

  for (int t = 0; t < T; ++t) {
    const size_t at = (size_t)t * B + b;
    const float r = regime[at];
#define G2(i) (pa[i] + pd[i] * r)
    const uint32_t dk = letf_day_key(lane_key, (uint32_t)t, s1);
    float nrm[6];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const float u1 = letf_stream_unit(dk, 2 * p + 1);
      const float u2 = letf_stream_unit(dk, 2 * p + 2);
      const float rad = sqrtf(-2.0f * logf(u1));
      const float ang = LETF_TWO_PI * u2;
      nrm[2 * p] = rad * cosf(ang);
      nrm[2 * p + 1] = rad * sinf(ang);
    }
    const float e0 = nrm[0] * sign, e1 = nrm[1] * sign, e2 = nrm[2] * sign;
    const float zc = nrm[3], vn = nrm[4], irxn = nrm[5];

    const float firstf = (t == 0) ? 1.0f : 0.0f;
    const float lv0 = G2(LV0), lv1 = G2(LV1), lv2 = G2(LV2);
    const float rb00 = G2(RB00), rb01 = G2(RB01), rb02 = G2(RB02);
    const float rb11 = G2(RB11), rb12 = G2(RB12), rb22 = G2(RB22);
    const float sw = fabsf(r - prev_r) * (1.0f - firstf);

    const float alpha = G2(ALPHA), beta = G2(BETA);
    const float one_ab = 1.0f - alpha - beta;
    const float g0 = jmax(one_ab * lv0 + alpha * z0 * z0 * h0 + beta * h0, 1e-10f);
    const float g1 = jmax(one_ab * lv1 + alpha * z1 * z1 * h1 + beta * h1, 1e-10f);
    const float g2 = jmax(one_ab * lv2 + alpha * z2 * z2 * h2 + beta * h2, 1e-10f);
    auto sel3 = [&](float lv, float garch, float h) {
      const float blend = 0.10f * lv + 0.90f * h;
      const float v = garch + sw * (blend - garch);
      return lv * firstf + v * (1.0f - firstf);
    };
    const float h0n = sel3(lv0, g0, h0), h1n = sel3(lv1, g1, h1),
                h2n = sel3(lv2, g2, h2);

    const float ad = G2(DCC_A), bd = G2(DCC_B);
    const float one_abd = 1.0f - ad - bd;
    auto qsel = [&](float rb, float q, float zz) {
      const float dcc = one_abd * rb + ad * zz + bd * q;
      const float blend = 0.10f * rb + 0.90f * q;
      const float v = dcc + sw * (blend - dcc);
      return rb * firstf + v * (1.0f - firstf);
    };
    const float q00n = qsel(rb00, q00, z0 * z0);
    const float q01n = qsel(rb01, q01, z0 * z1);
    const float q02n = qsel(rb02, q02, z0 * z2);
    const float q11n = qsel(rb11, q11, z1 * z1);
    const float q12n = qsel(rb12, q12, z1 * z2);
    const float q22n = qsel(rb22, q22, z2 * z2);

    const float d0 = sqrtf(jmax(q00n, 1e-12f));
    const float d1 = sqrtf(jmax(q11n, 1e-12f));
    const float d2 = sqrtf(jmax(q22n, 1e-12f));
    const float sa = sqrtf(h0n), sb = sqrtf(h1n), sc = sqrtf(h2n);
    const float c00 = (q00n / (d0 * d0)) * sa * sa;
    const float c01 = (q01n / (d0 * d1)) * sa * sb;
    const float c02 = (q02n / (d0 * d2)) * sa * sc;
    const float c11 = (q11n / (d1 * d1)) * sb * sb;
    const float c12 = (q12n / (d1 * d2)) * sb * sc;
    const float c22 = (q22n / (d2 * d2)) * sc * sc;

    const float epsv = 1e-18f;
    const float l00 = sqrtf(jmax(c00, epsv));
    const float l10 = c01 / l00;
    const float l20 = c02 / l00;
    const float l11 = sqrtf(jmax(c11 - l10 * l10, epsv));
    const float l21 = (c12 - l20 * l10) / l11;
    const float l22 = sqrtf(jmax(c22 - l20 * l20 - l21 * l21, epsv));
    const float zz0 = l00 * e0;
    const float zz1 = l10 * e0 + l11 * e1;
    const float zz2 = l20 * e0 + l21 * e1 + l22 * e2;

    // chi-square(nu_r) by one Clenshaw pass over the regime-blended table.
    const float tc = jclip(zc * (float)(1.0 / 6.3), -1.0f, 1.0f);
    float b1 = 0.f, b2 = 0.f;
    for (int k = n_cheb - 1; k > 0; --k) {
      const float ck = ca[k] + cd[k] * r;
      const float nb1 = ck + 2.0f * tc * b1 - b2;
      b2 = b1;
      b1 = nb1;
    }
    const float c0k = ca[0] + cd[0] * r;
    const float u_chi = expf(c0k + tc * b1 - b2);

    const float scale = sqrtf(G2(NU) / jmax(u_chi, 1e-12f));
    const float mu0 = G2(MU0), mu1 = G2(MU1), mu2 = G2(MU2);
    const float x0 = jclip(mu0 + zz0 * scale, -0.95f, 4.0f);
    const float x1 = jclip(mu1 + zz1 * scale, -0.95f, 4.0f);
    const float x2 = jclip(mu2 + zz2 * scale, -0.95f, 4.0f);
    z0 = (x0 - mu0) / sqrtf(jmax(h0n, 1e-10f));
    z1 = (x1 - mu1) / sqrtf(jmax(h1n, 1e-10f));
    z2 = (x2 - mu2) / sqrtf(jmax(h2n, 1e-10f));

    const float shock = jmax(-x0, 0.0f) / jmax(G2(DSTD), 1e-4f);
    const float vjump = G2(VJSCL) * jmax(shock - G2(VJTHR), 0.0f);
    const float phi = G2(VPHI);
    const float vix_ar = jmax(
        phi * vixp + (1.0f - phi) * G2(VTGT) + vjump + G2(VNOISE) * vn, 10.0f);
    const float vix_t = G2(VBASE) * firstf + vix_ar * (1.0f - firstf);
    const float irx_t = jclip(G2(IRXB) + 0.5f * irxn, 0.0f, 15.0f);
#undef G2

    x0o[at] = x0;
    x1o[at] = x1;
    x2o[at] = x2;
    vixo[at] = vix_t;
    irxo[at] = irx_t;
    h0 = h0n; h1 = h1n; h2 = h2n;
    q00 = q00n; q01 = q01n; q02 = q02n; q11 = q11n; q12 = q12n; q22 = q22n;
    prev_r = r;
    vixp = vix_t;
  }
}

}  // namespace

extern "C" int letf_joint(const float* params, const float* cheb, int n_cheb,
                          const float* regime, const int* ids,
                          const float* signs, unsigned int s0,
                          unsigned int s1, int T, int B, float* x0,
                          float* x1, float* x2, float* vix, float* irx,
                          void* stream) {
  // 32-thread blocks spread the few warps of a chunk evenly over the SMs.
  const int threads = 32;
  const int blocks = (B + threads - 1) / threads;
  if (B > 0 && n_cheb > 0 && n_cheb <= kMaxCheb) {
    joint_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        params, cheb, n_cheb, regime, ids, signs, s0, s1, T, B, x0, x1, x2,
        vix, irx);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* letf_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int letf_info_joint(int* out) {
  return letf_fill_info((const void*)joint_kernel, 32, 0, out);
}
