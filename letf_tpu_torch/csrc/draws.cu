// The per-trial engine's samplers: jax.random's normal, gamma and t in
// JAX's partitionable threefry mode, one thread a draw.
//
// Replaces no Pallas kernel: the JAX package draws these with jax.random
// in XLA (letf_tpu/ops/path_engine.py: draw_innovations,
// generate_returns_parametric). The port's first version is the torch code
// of ops/rng.py (normal, gamma, t), which stays as the CPU twin: chains of
// int64 elementwise ops, each reading and writing its whole tensor in
// device memory, and for gamma one host round trip a rejection round (a
// boolean index of the still-active elements). Here each thread owns flat
// draws (b, j) of the [B, n] output and does the whole draw in registers:
// the threefry2x32 hashes on native 32-bit words, the mantissa fill, XLA's
// erf_inv polynomial and, for gamma, the Marsaglia-Tsang loop as
// rng._gamma_one carries it per element (split 3 of the running key into
// next key, x key and U key; the inner redraw while v <= 0 with split 2 of
// the x key; the alpha < 1 boost by U^(1/alpha)). An element's draw depends
// only on its key and j, never on which elements are still active, so the
// per-thread loop gives the batch loop's values with no host round.
//
// Every value is bitwise the twin's on the card, in float32 and float64
// (tests/test_torch_draws_cuda.py): every product, sum and difference is a
// _rn intrinsic, rounded where the twin's ops round and never contracted;
// the logs, log1p, square roots and powers are the libdevice functions
// torch's kernels call, built as torch builds them (this source alone keeps
// nvcc's default -fmad=true, ops/_build.py: libdevice's float64 pow
// contracts its own products, and under -fmad=false 7 of 1M float64
// draws at alpha 0.4 moved by an ulp); the scalar constants are rounded
// in the draw's dtype from the same doubles. No fast math.
//
// What bounds it on the H100: 32-bit integer operations. A hash is 20
// rounds of add, rotate and xor with 5 key injections: 68 SASS
// instructions in the sm_90a build, 56 of them on the integer ALU pipe
// (IADD3, LOP3, SHF.L.W; 64 lanes an SM a clock) and 12 adds the compiler
// issues on the FMA pipe (IMAD.IADD), counted in cuobjdump -sass of
// normal_kernel<float>. A normal is 1 hash and ~40 float operations; a
// gamma 7 hashes when it accepts its first x (its element key, that key's
// split, the x key, the normal key, the normal, the U key, U), 2 more for
// alpha < 1; a t 8 (its normal and its gamma; the rows' split keys are
// hashed once a row by t_keys_kernel): ~450 ALU operations a t draw, more
// where a round is redrawn or rejected. chip_smoke.py's draws phase times
// the kernel beside that floor. Its only bytes are the outputs (4 or 8 a draw,
// written once, coalesced: neighbouring threads own neighbouring j) and
// the keys, read through the cache.

#include "common.cuh"

namespace {

struct Key {
  uint32_t a, b;
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

#define LETF_TF_ROUND(r) \
  x0 += x1;              \
  x1 = rotl(x1, r) ^ x0;

// threefry2x32 (20 rounds) of the counter (x0, x1) under key k
// (ops/rng.threefry2x32); both output words.
__device__ __forceinline__ Key threefry(Key k, uint32_t x0, uint32_t x1) {
  const uint32_t k2 = k.a ^ k.b ^ 0x1BD11BDAu;
  x0 += k.a;
  x1 += k.b;
  LETF_TF_ROUND(13) LETF_TF_ROUND(15) LETF_TF_ROUND(26) LETF_TF_ROUND(6)
  x0 += k.b;
  x1 += k2 + 1u;
  LETF_TF_ROUND(17) LETF_TF_ROUND(29) LETF_TF_ROUND(16) LETF_TF_ROUND(24)
  x0 += k2;
  x1 += k.a + 2u;
  LETF_TF_ROUND(13) LETF_TF_ROUND(15) LETF_TF_ROUND(26) LETF_TF_ROUND(6)
  x0 += k.a;
  x1 += k.b + 3u;
  LETF_TF_ROUND(17) LETF_TF_ROUND(29) LETF_TF_ROUND(16) LETF_TF_ROUND(24)
  x0 += k.b;
  x1 += k2 + 4u;
  LETF_TF_ROUND(13) LETF_TF_ROUND(15) LETF_TF_ROUND(26) LETF_TF_ROUND(6)
  x0 += k2;
  x1 += k.a + 5u;
  return {x0, x1};
}

#undef LETF_TF_ROUND

// split(k, n)[i]: the hash of the counter (0, i).
__device__ __forceinline__ Key split_at(Key k, uint32_t i) {
  return threefry(k, 0u, i);
}

// The math of the draw's dtype: products, sums and differences rounded
// apart (the _rn intrinsics are never contracted), and the libdevice
// functions torch's kernels call.
__device__ __forceinline__ float r_add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double r_add(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float r_sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ double r_sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ float r_mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double r_mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float m_log(float x) { return logf(x); }
__device__ __forceinline__ double m_log(double x) { return log(x); }
__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) {
  return pow(x, y);
}
__device__ __forceinline__ float m_max(float x, float y) {
  return fmaxf(x, y);
}
__device__ __forceinline__ double m_max(double x, double y) {
  return fmax(x, y);
}

// nextafter(-1, 0) in T, the normal's least input to erf_inv.
template <typename T>
__device__ T above_minus_one();

template <>
__device__ __forceinline__ float above_minus_one<float>() {
  return nextafterf(-1.0f, 0.0f);
}

template <>
__device__ __forceinline__ double above_minus_one<double>() {
  return nextafter(-1.0, 0.0);
}

// The [1, 2) mantissa fill of jax.random.uniform minus 1
// (rng._unit_floats) of a hash's two words.
template <typename T>
__device__ T unit_float(Key bits);

template <>
__device__ __forceinline__ float unit_float<float>(Key bits) {
  return r_sub(__uint_as_float(((bits.a ^ bits.b) >> 9) | 0x3F800000u),
               1.0f);
}

template <>
__device__ __forceinline__ double unit_float<double>(Key bits) {
  const uint64_t m = ((uint64_t)bits.a << 32 | bits.b) >> 12;
  return r_sub(__longlong_as_double((long long)(m | 0x3FF0000000000000ull)),
               1.0);
}

// Horner's rule as rng.erf_inv runs it: p = c[0], then p = c[i] + p * w,
// a product and a sum rounded apart.
template <typename T, int N>
__device__ __forceinline__ T horner(const T (&c)[N], T w) {
  T p = c[0];
#pragma unroll
  for (int i = 1; i < N; ++i) p = r_add(c[i], r_mul(p, w));
  return p;
}

// XLA's erf_inv (rng.erf_inv), float32: one of two degree-8 fits by
// w = -log1p(-x^2) < 5. The coefficients are the twin's doubles rounded to
// float32.
__device__ __forceinline__ float erf_inv(float x) {
  constexpr float small[9] = {
      (float)2.81022636e-08, (float)3.43273939e-07, (float)-3.5233877e-06,
      (float)-4.39150654e-06, (float)0.00021858087, (float)-0.00125372503,
      (float)-0.00417768164, (float)0.246640727, (float)1.50140941};
  constexpr float big[9] = {
      (float)-0.000200214257, (float)0.000100950558, (float)0.00134934322,
      (float)-0.00367342844, (float)0.00573950773, (float)-0.0076224613,
      (float)0.00943887047, (float)1.00167406, (float)2.83297682};
  const float w = -log1pf(r_mul(-x, x));
  const float p = w < 5.0f ? horner(small, r_sub(w, 2.5f))
                           : horner(big, r_sub(sqrtf(w), 3.0f));
  return fabsf(x) == 1.0f ? r_mul(x, INFINITY) : r_mul(p, x);
}

// float64: three fits split at w = 6.25 and 16.
__device__ __forceinline__ double erf_inv(double x) {
  constexpr double c6[23] = {
      -3.6444120640178196996e-21, -1.685059138182016589e-19,
      1.2858480715256400167e-18, 1.115787767802518096e-17,
      -1.333171662854620906e-16, 2.0972767875968561637e-17,
      6.6376381343583238325e-15, -4.0545662729752068639e-14,
      -8.1519341976054721522e-14, 2.6335093153082322977e-12,
      -1.2975133253453532498e-11, -5.4154120542946279317e-11,
      1.051212273321532285e-09, -4.1126339803469836976e-09,
      -2.9070369957882005086e-08, 4.2347877827932403518e-07,
      -1.3654692000834678645e-06, -1.3882523362786468719e-05,
      0.0001867342080340571352, -0.00074070253416626697512,
      -0.0060336708714301490533, 0.24015818242558961693,
      1.6536545626831027356};
  constexpr double c16[19] = {
      2.2137376921775787049e-09, 9.0756561938885390979e-08,
      -2.7517406297064545428e-07, 1.8239629214389227755e-08,
      1.5027403968909827627e-06, -4.013867526981545969e-06,
      2.9234449089955446044e-06, 1.2475304481671778723e-05,
      -4.7318229009055733981e-05, 6.8284851459573175448e-05,
      2.4031110387097893999e-05, -0.0003550375203628474796,
      0.00095328937973738049703, -0.0016882755560235047313,
      0.0024914420961078508066, -0.0037512085075692412107,
      0.005370914553590063617, 1.0052589676941592334,
      3.0838856104922207635};
  constexpr double cbig[17] = {
      -2.7109920616438573243e-11, -2.5556418169965252055e-10,
      1.5076572693500548083e-09, -3.7894654401267369937e-09,
      7.6157012080783393804e-09, -1.4960026627149240478e-08,
      2.9147953450901080826e-08, -6.7711997758452339498e-08,
      2.2900482228026654717e-07, -9.9298272942317002539e-07,
      4.5260625972231537039e-06, -1.9681778105531670567e-05,
      7.5995277030017761139e-05, -0.00021503011930044477347,
      -0.00013871931833623122026, 1.0103004648645343977,
      4.8499064014085844221};
  const double w = -log1p(r_mul(-x, x));
  double p;
  if (w < 6.25) {
    p = horner(c6, r_sub(w, 3.125));
  } else if (w < 16.0) {
    p = horner(c16, r_sub(sqrt(w), 3.25));
  } else {
    p = horner(cbig, r_sub(sqrt(w), 5.0));
  }
  return fabs(x) == 1.0 ? r_mul(x, (double)INFINITY) : r_mul(p, x);
}

// jax.random.normal of counter j under key k (rng.normal):
// sqrt(2) erf_inv(max(lo, f * (1 - lo) + lo)) with lo = nextafter(-1, 0).
template <typename T>
__device__ __forceinline__ T normal_at(Key k, uint32_t j) {
  const T f = unit_float<T>(threefry(k, 0u, j));
  const T lo = above_minus_one<T>();
  const T u = m_max(lo, r_add(r_mul(f, r_sub((T)1, lo)), lo));
  return r_mul((T)1.4142135623730951, erf_inv(u));
}

// The gamma sampler's constants for one alpha, rounded in T as
// rng._gamma_one forms them from torch scalars.
template <typename T>
struct GammaC {
  T d, c, inv;
  bool boost;
  __device__ __forceinline__ GammaC(T alpha, bool boost_) : boost(boost_) {
    const T third = (T)(1.0 / 3.0);
    d = r_sub(boost ? alpha : r_add(alpha, (T)1), third);
    c = third / m_sqrt(d);
    inv = (T)1 / alpha;
  }
};

// rng._gamma_one of one element key ek (Marsaglia-Tsang). A key is hashed
// only where its value is read: the next round's key (split 0 of the round
// key) only after a rejection, the next x key (split 0 of the x key) only
// after a redraw, so a draw accepted at its first x hashes 7 times (ek, its
// split 0, the x key, the normal key, the normal, the U key, U) and an
// alpha < 1 draw 2 more (the boost's key and its uniform).
template <typename T>
__device__ __forceinline__ T gamma_at(Key ek, const GammaC<T>& g) {
  const T sq = (T)0.0331;
  Key key = split_at(ek, 0u);
  T V;
  for (;;) {
    Key kx = split_at(key, 1u);
    T x, v;
    for (;;) {
      x = normal_at<T>(split_at(kx, 1u), 0u);
      v = r_add((T)1, r_mul(x, g.c));
      if (!(v <= (T)0)) break;
      kx = split_at(kx, 0u);
    }
    const T X = r_mul(x, x);
    V = r_mul(r_mul(v, v), v);
    const T U = unit_float<T>(threefry(split_at(key, 2u), 0u, 0u));
    const bool rejected =
        (U >= r_sub((T)1, r_mul(sq, r_mul(X, X)))) &&
        (m_log(U) >= r_add(r_mul(X, (T)0.5),
                           r_mul(g.d, r_add(r_sub((T)1, V), m_log(V)))));
    if (!rejected) break;
    key = split_at(key, 0u);
  }
  const T dv = r_mul(g.d, V);
  if (g.boost) return dv;
  const T u = r_sub((T)1, unit_float<T>(threefry(split_at(ek, 1u), 0u, 0u)));
  return r_mul(dv, m_pow(u, g.inv));
}

__device__ __forceinline__ Key load_key(const long long* keys, long long b) {
  return {(uint32_t)keys[2 * b], (uint32_t)keys[2 * b + 1]};
}

// Each kernel walks the flat draws idx = b * n + j of its [B, n] output.
template <typename T>
__global__ void __launch_bounds__(256)
normal_kernel(const long long* __restrict__ keys, long long total,
              long long n, uint32_t lo, T* __restrict__ out) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / n;
    out[idx] = normal_at<T>(load_key(keys, b),
                            lo + (uint32_t)(idx - b * n));
  }
}

// jax.random.gamma: element j's key is split(key, n)[j]. boost (alpha >=
// 1) comes from the caller's double alpha, as the twin decides it on the
// Python float before rounding.
template <typename T>
__global__ void __launch_bounds__(256)
gamma_kernel(const long long* __restrict__ keys, long long total,
             long long n, T alpha, int boost, T* __restrict__ out) {
  const GammaC<T> g(alpha, boost != 0);
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / n;
    const uint32_t j = (uint32_t)(idx - b * n);
    out[idx] = gamma_at<T>(split_at(load_key(keys, b), j), g);
  }
}

// jax.random.t's per-row keys: (normal key, gamma key) = split(key, 2) of
// each row's key, as uint4 (normal a, normal b, gamma a, gamma b), so that
// t_kernel hashes them once a row and not once a draw.
__global__ void __launch_bounds__(256)
t_keys_kernel(const long long* __restrict__ keys, long long rows,
              uint4* __restrict__ row_keys) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       b < rows; b += (long long)gridDim.x * blockDim.x) {
    const Key k = load_key(keys, b);
    const Key z = split_at(k, 0u), gk = split_at(k, 1u);
    row_keys[b] = make_uint4(z.a, z.b, gk.a, gk.b);
  }
}

// jax.random.t: z * sqrt(half / gamma(half)) with half = df / 2 in T, z the
// normal of the row's normal key and the gamma of element j's key under the
// row's gamma key (t_keys_kernel): 8 hashes a draw accepted at its first x.
template <typename T>
__global__ void __launch_bounds__(256)
t_kernel(const uint4* __restrict__ row_keys, long long total, long long n,
         T df, T* __restrict__ out) {
  const T half = r_mul(df, (T)0.5);
  const GammaC<T> g(half, half >= (T)1);
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long b = idx / n;
    const uint32_t j = (uint32_t)(idx - b * n);
    const uint4 rk = row_keys[b];
    const T z = normal_at<T>(Key{rk.x, rk.y}, j);
    const T gm = gamma_at<T>(split_at(Key{rk.z, rk.w}, j), g);
    out[idx] = r_mul(z, m_sqrt(half / gm));
  }
}

constexpr int kThreads = 256;

int blocks_for(long long total) {
  const long long want = (total + kThreads - 1) / kThreads;
  return (int)(want < (1 << 20) ? want : (1 << 20));
}

}  // namespace

// C entries: keys int64 [B, 2] (uint32 words), contiguous; out [B, n] of
// float32 (dbl = 0) or float64 (dbl = 1). The last argument is the stream.
extern "C" int letf_draw_normal(const long long* keys, long long rows,
                                long long n, long long lo, int dbl,
                                void* out, void* stream) {
  const long long total = rows * n;
  if (total > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (dbl)
      normal_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          keys, total, n, (uint32_t)lo, (double*)out);
    else
      normal_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          keys, total, n, (uint32_t)lo, (float*)out);
  }
  return (int)cudaGetLastError();
}

extern "C" int letf_draw_gamma(const long long* keys, long long rows,
                               long long n, double alpha, int boost, int dbl,
                               void* out, void* stream) {
  const long long total = rows * n;
  if (total > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (dbl)
      gamma_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          keys, total, n, alpha, boost, (double*)out);
    else
      gamma_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          keys, total, n, (float)alpha, boost, (float*)out);
  }
  return (int)cudaGetLastError();
}

// row_keys: scratch of rows x 16 bytes (t_keys_kernel's output), aligned
// to 16 bytes.
extern "C" int letf_draw_t(const long long* keys, long long rows, long long n,
                           double df, void* row_keys, int dbl, void* out,
                           void* stream) {
  const long long total = rows * n;
  if (total > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    uint4* rk = (uint4*)row_keys;
    t_keys_kernel<<<blocks_for(rows), kThreads, 0, s>>>(keys, rows, rk);
    if (dbl)
      t_kernel<double><<<blocks_for(total), kThreads, 0, s>>>(
          rk, total, n, df, (double*)out);
    else
      t_kernel<float><<<blocks_for(total), kThreads, 0, s>>>(
          rk, total, n, (float)df, (float*)out);
  }
  return (int)cudaGetLastError();
}

// letf_kernel_info's entries for the float32 kernels (which: 0 normal,
// 1 gamma, 2 t).
extern "C" int letf_info_draws(int which, int* out) {
  const void* fn = which == 0   ? (const void*)normal_kernel<float>
                   : which == 1 ? (const void*)gamma_kernel<float>
                                : (const void*)t_kernel<float>;
  return letf_fill_info(fn, kThreads, 0, out);
}
