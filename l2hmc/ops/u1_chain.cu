// Whole-chain U(1) HMC on one GPU thread block per chain.
//
// One launch runs N complete HMC transitions (K leapfrog steps of the
// Wilson-action force, the mod-2pi wrap, the Hamiltonian and the MH
// accept, optionally one exact instanton hop) for every chain.  A chain's
// proposal links and plaquette sines live in shared memory for the whole
// launch; the current state, momenta and carried plaquette fields of each
// site live in the registers of the thread that owns the site.  Device
// memory sees the initial state once, the final state once and three
// (N, chains) observable rows.
//
// The arithmetic mirrors ops/leapfrog.py (_transition_math, _hop_math)
// operation for operation; hmc_chain_reference there is the plain
// reference this kernel is compared with.
//
// Randomness: either injected as arrays (exactness checks) or drawn from
// Philox4x32-10 keyed by the call's two seed words, with counter
// (site, transition, chain, 0).  The per-chain scalars (accept uniform,
// hop direction and hop uniform) use the counter (D, transition, chain, 0),
// one past the last site.  Box-Muller turns two uniforms into the two
// momenta of a site.  ops/leapfrog.py holds the numpy model of the bits.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
// -Xcompiler -fPIC -I <jax.ffi.include_dir()>, without --use_fast_math so
// that sin, cos, exp and log round as XLA's do.

#include <cmath>
#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;
constexpr float kInvTwoPi = 0.15915494309189533577f;
constexpr int kMaxWarps = 32;

// scal layout (float32, filled by ops/leapfrog.py _kernel_scalars)
enum {
  kEps, kBeta, kCosD, kSinD, kOneMinusCosD, kWindStep, kWindSeam, kNumScal
};

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint2 k) {
  const uint32_t m0 = 0xD2511F53u, m1 = 0xCD9E8D57u;
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t hi0 = __umulhi(m0, c.x), lo0 = m0 * c.x;
    const uint32_t hi1 = __umulhi(m1, c.z), lo1 = m1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k.x, lo1, hi0 ^ c.w ^ k.y, lo0);
    k.x += 0x9E3779B9u;
    k.y += 0xBB67AE85u;
  }
  return c;
}

// 23 random bits -> float in (0, 1), exact: (2k + 1) / 2^24.
__device__ __forceinline__ float uniform_open(uint32_t bits) {
  return static_cast<float>(bits >> 9) * (1.0f / 8388608.0f) +
         (1.0f / 16777216.0f);
}

__device__ __forceinline__ float wrap_angle(float x) {
  return x - kTwoPi * floorf((x + kPi) / kTwoPi);
}

// Sum NV per-thread values over the block; every thread gets the totals,
// added in the same order everywhere.  blockDim.x is a multiple of 32.
template <int NV>
__device__ __forceinline__ void block_sum(float (&v)[NV], float* red) {
#pragma unroll
  for (int n = 0; n < NV; ++n) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
    }
  }
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  __syncthreads();  // earlier readers of red are done
  if ((threadIdx.x & 31) == 0) {
#pragma unroll
    for (int n = 0; n < NV; ++n) red[n * kMaxWarps + warp] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NV; ++n) {
    float s = 0.0f;
    for (int w = 0; w < nwarps; ++w) s += red[n * kMaxWarps + w];
    v[n] = s;
  }
}

template <int SPT, bool HOP, bool INJECTED>
__global__ void __launch_bounds__(1024) u1_chain_kernel(
    const float* __restrict__ x0_in, const float* __restrict__ x1_in,
    const float* __restrict__ scal, const uint32_t* __restrict__ seed,
    const float* __restrict__ v0s, const float* __restrict__ v1s,
    const float* __restrict__ us, const float* __restrict__ nus,
    const float* __restrict__ uhs, float* __restrict__ x0_out,
    float* __restrict__ x1_out, float* __restrict__ plaq_out,
    float* __restrict__ chg_out, float* __restrict__ prob_out, int lt,
    int lx, int num_leapfrog, int num_transitions, int num_chains) {
  extern __shared__ float smem[];
  const int d = lt * lx;
  float* y0s = smem;              // proposal links, direction 0
  float* y1s = smem + d;          // proposal links, direction 1
  float* sins = smem + 2 * d;     // sin P of the proposal / current state
  float* red = smem + 3 * d;      // block-reduction scratch
  const int chain = blockIdx.x;
  const int nthreads = blockDim.x;
  const size_t base = static_cast<size_t>(chain) * d;

  const float eps = scal[kEps];
  const float beta = scal[kBeta];
  const float cos_d = scal[kCosD];
  const float sin_d = scal[kSinD];
  const float one_minus_cos_d = scal[kOneMinusCosD];
  const uint2 key = make_uint2(seed[0], seed[1]);

  // Sites owned by this thread: i = tid + j * nthreads.
  int ti[SPT], si[SPT];
  float x0[SPT], x1[SPT], sp[SPT], cp[SPT], w0[SPT], w1[SPT];
#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = threadIdx.x + j * nthreads;
    ti[j] = i / lx;
    si[j] = i - ti[j] * lx;
    if (i < d) {
      x0[j] = x0_in[base + i];
      x1[j] = x1_in[base + i];
      y0s[i] = x0[j];
      y1s[i] = x1[j];
    }
  }
  __syncthreads();

  // Neighbours of site i = t * lx + s on the periodic lattice.
#define SITE_I(j) (threadIdx.x + (j) * nthreads)
#define S_PLUS(j) (si[j] == lx - 1 ? SITE_I(j) - (lx - 1) : SITE_I(j) + 1)
#define S_MINUS(j) (si[j] == 0 ? SITE_I(j) + (lx - 1) : SITE_I(j) - 1)
#define T_PLUS(j) (ti[j] == lt - 1 ? si[j] : SITE_I(j) + lx)
#define T_MINUS(j) (ti[j] == 0 ? SITE_I(j) + (lt - 1) * lx : SITE_I(j) - lx)

  // Plaquette fields of the initial state: potential, charge, sin, cos.
  float pot, chg;
  {
    float acc[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int i = SITE_I(j);
      if (i < d) {
        const float p = y0s[i] - y1s[i] - y0s[S_PLUS(j)] + y1s[T_PLUS(j)];
        sp[j] = sinf(p);
        cp[j] = cosf(p);
        acc[0] += 1.0f - cp[j];
        acc[1] += wrap_angle(p);
      }
    }
    block_sum<2>(acc, red);
    pot = acc[0];
    chg = acc[1] * kInvTwoPi;
  }

  for (int t = 0; t < num_transitions; ++t) {
    const size_t row = static_cast<size_t>(t) * num_chains + chain;
    float ke0 = 0.0f;
    float v0[SPT], v1[SPT];
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int i = SITE_I(j);
      if (i < d) {
        if constexpr (INJECTED) {
          v0[j] = v0s[row * d + i];
          v1[j] = v1s[row * d + i];
        } else {
          const uint4 r = philox4x32_10(
              make_uint4(static_cast<uint32_t>(i), static_cast<uint32_t>(t),
                         static_cast<uint32_t>(chain), 0u),
              key);
          const float rad = sqrtf(-2.0f * logf(uniform_open(r.x)));
          float s, c;
          sincospif(2.0f * uniform_open(r.y), &s, &c);
          v0[j] = rad * c;
          v1[j] = rad * s;
        }
        ke0 += v0[j] * v0[j] + v1[j] * v1[j];
        y0s[i] = x0[j];
        y1s[i] = x1[j];
        sins[i] = sp[j];
      }
    }
    __syncthreads();
    const float half_kick = 0.5f * eps * beta;
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      const int i = SITE_I(j);
      if (i < d) {
        const float g0 = sins[i] - sins[S_MINUS(j)];
        const float g1 = -sins[i] + sins[T_MINUS(j)];
        w0[j] = v0[j] - half_kick * g0;
        w1[j] = v1[j] - half_kick * g1;
      }
    }

    float pot1 = 0.0f, chg1 = 0.0f;
    float cpn[SPT];
    for (int k = 0; k < num_leapfrog; ++k) {
      const bool last = (k == num_leapfrog - 1);
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = SITE_I(j);
        if (i < d) {
          y0s[i] = wrap_angle(y0s[i] + eps * w0[j]);
          y1s[i] = wrap_angle(y1s[i] + eps * w1[j]);
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = SITE_I(j);
        if (i < d) {
          const float p = y0s[i] - y1s[i] - y0s[S_PLUS(j)] + y1s[T_PLUS(j)];
          sins[i] = sinf(p);
          if (last) {
            cpn[j] = cosf(p);
            pot1 += 1.0f - cpn[j];
            chg1 += wrap_angle(p);
          }
        }
      }
      __syncthreads();
      const float kick = (last ? 0.5f * eps : eps) * beta;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = SITE_I(j);
        if (i < d) {
          const float g0 = sins[i] - sins[S_MINUS(j)];
          const float g1 = -sins[i] + sins[T_MINUS(j)];
          w0[j] = w0[j] - kick * g0;
          w1[j] = w1[j] - kick * g1;
        }
      }
    }

    float sums[4] = {ke0, 0.0f, pot1, chg1};
#pragma unroll
    for (int j = 0; j < SPT; ++j) {
      if (SITE_I(j) < d) sums[1] += w0[j] * w0[j] + w1[j] * w1[j];
    }
    block_sum<4>(sums, red);
    pot1 = sums[2];
    chg1 = sums[3] * kInvTwoPi;
    const float dh = (beta * pot + 0.5f * sums[0]) - (beta * pot1 + 0.5f * sums[1]);
    float prob = expf(fminf(dh, 0.0f));
    if (!isfinite(prob)) prob = 0.0f;

    float u, nu = 0.0f, uh = 0.0f;
    if constexpr (INJECTED) {
      u = us[row];
      if constexpr (HOP) {
        nu = nus[row];
        uh = uhs[row];
      }
    } else {
      const uint4 r = philox4x32_10(
          make_uint4(static_cast<uint32_t>(d), static_cast<uint32_t>(t),
                     static_cast<uint32_t>(chain), 0u),
          key);
      u = uniform_open(r.x);
      nu = (r.y & 1u) ? 1.0f : -1.0f;
      uh = uniform_open(r.z);
    }

    if (u < prob) {
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        const int i = SITE_I(j);
        if (i < d) {
          x0[j] = y0s[i];
          x1[j] = y1s[i];
          sp[j] = sins[i];
          if constexpr (HOP) cp[j] = cpn[j];
        }
      }
      pot = pot1;
      chg = chg1;
    }

    if constexpr (HOP) {
      // One exact instanton hop on the carried fields (_hop_math).
      float hs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        if (SITE_I(j) < d) {
          hs[0] += sp[j];
          hs[1] += (cp[j] < -cos_d && nu * sp[j] >= 0.0f) ? 1.0f : 0.0f;
        }
      }
      block_sum<2>(hs, red);
      const float ds = one_minus_cos_d * (static_cast<float>(d) - pot) +
                       nu * sin_d * hs[0];
      float prob_h = expf(fminf(-beta * ds, 0.0f));
      if (!isfinite(prob_h)) prob_h = 0.0f;
      const float acc_h = (uh < prob_h) ? 1.0f : 0.0f;
      const float an = acc_h * nu;
      const float cda = 1.0f + acc_h * (-one_minus_cos_d);
      const float sda = an * sin_d;
#pragma unroll
      for (int j = 0; j < SPT; ++j) {
        if (SITE_I(j) < d) {
          const float wf0 = (ti[j] == lt - 1)
                                ? scal[kWindSeam] * static_cast<float>(si[j])
                                : 0.0f;
          const float wf1 = scal[kWindStep] * static_cast<float>(ti[j]);
          x0[j] = wrap_angle(x0[j] + an * wf0);
          x1[j] = wrap_angle(x1[j] + an * wf1);
          const float s_new = sp[j] * cda + cp[j] * sda;
          const float c_new = cp[j] * cda - sp[j] * sda;
          sp[j] = s_new;
          cp[j] = c_new;
        }
      }
      pot = pot + acc_h * ds;
      chg = chg + an * (1.0f - hs[1]);
    }

    if (threadIdx.x == 0) {
      plaq_out[row] = 1.0f - pot / static_cast<float>(d);
      chg_out[row] = chg;
      prob_out[row] = prob;
    }
  }

#pragma unroll
  for (int j = 0; j < SPT; ++j) {
    const int i = SITE_I(j);
    if (i < d) {
      x0_out[base + i] = x0[j];
      x1_out[base + i] = x1[j];
    }
  }
#undef SITE_I
#undef S_PLUS
#undef S_MINUS
#undef T_PLUS
#undef T_MINUS
}

template <int SPT, bool HOP, bool INJECTED>
cudaError_t launch_spt(cudaStream_t stream, int threads, size_t smem,
                       const float* x0, const float* x1, const float* scal,
                       const uint32_t* seed, const float* v0s,
                       const float* v1s, const float* us, const float* nus,
                       const float* uhs, float* x0o, float* x1o, float* plaq,
                       float* chg, float* prob, int lt, int lx, int k, int n,
                       int b) {
  auto kernel = u1_chain_kernel<SPT, HOP, INJECTED>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<b, threads, smem, stream>>>(x0, x1, scal, seed, v0s, v1s, us, nus,
                                       uhs, x0o, x1o, plaq, chg, prob, lt, lx,
                                       k, n, b);
  return cudaGetLastError();
}

template <bool HOP, bool INJECTED>
cudaError_t launch(int spt, cudaStream_t stream, int threads, size_t smem,
                   const float* x0, const float* x1, const float* scal,
                   const uint32_t* seed, const float* v0s, const float* v1s,
                   const float* us, const float* nus, const float* uhs,
                   float* x0o, float* x1o, float* plaq, float* chg,
                   float* prob, int lt, int lx, int k, int n, int b) {
#define L2HMC_LAUNCH(S)                                                     \
  return launch_spt<S, HOP, INJECTED>(stream, threads, smem, x0, x1, scal, \
                                      seed, v0s, v1s, us, nus, uhs, x0o,   \
                                      x1o, plaq, chg, prob, lt, lx, k, n, b)
  switch (spt) {
    case 1: L2HMC_LAUNCH(1);
    case 2: L2HMC_LAUNCH(2);
    case 4: L2HMC_LAUNCH(4);
    case 8: L2HMC_LAUNCH(8);
    case 16: L2HMC_LAUNCH(16);
    default: return cudaErrorInvalidValue;
  }
#undef L2HMC_LAUNCH
}

struct Geometry {
  int lt, lx, k, n, b, threads, spt;
  size_t smem;
};

ffi::Error check_geometry(const Geometry& g, const ffi::AnyBuffer::Dimensions&
                          x_dims, const ffi::AnyBuffer::Dimensions& tr_dims) {
  const int d = g.lt * g.lx;
  if (x_dims.size() != 2 || x_dims[1] != d || tr_dims.size() != 2 ||
      tr_dims[1] != x_dims[0]) {
    return ffi::Error::InvalidArgument("u1 chain: bad state/trace shapes");
  }
  if (g.threads % 32 != 0 || g.threads > 1024 || g.threads * g.spt < d) {
    return ffi::Error::InvalidArgument("u1 chain: bad thread layout");
  }
  return ffi::Error::Success();
}

ffi::Error finish(cudaError_t err) {
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("u1 chain launch failed: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

ffi::Error ChainPhilox(cudaStream_t stream, ffi::Buffer<ffi::F32> x0,
                       ffi::Buffer<ffi::F32> x1, ffi::Buffer<ffi::F32> scal,
                       ffi::Buffer<ffi::U32> seed,
                       ffi::ResultBuffer<ffi::F32> x0o,
                       ffi::ResultBuffer<ffi::F32> x1o,
                       ffi::ResultBuffer<ffi::F32> plaq,
                       ffi::ResultBuffer<ffi::F32> chg,
                       ffi::ResultBuffer<ffi::F32> prob, int64_t lt,
                       int64_t lx, int64_t num_leapfrog, int64_t hop,
                       int64_t threads, int64_t spt, int64_t smem) {
  const auto xd = x0.dimensions();
  const auto td = plaq->dimensions();
  Geometry g{static_cast<int>(lt), static_cast<int>(lx),
             static_cast<int>(num_leapfrog), static_cast<int>(td[0]),
             static_cast<int>(xd[0]), static_cast<int>(threads),
             static_cast<int>(spt), static_cast<size_t>(smem)};
  ffi::Error e = check_geometry(g, xd, td);
  if (e.failure()) return e;
  auto* fn = hop ? launch<true, false> : launch<false, false>;
  return finish(fn(g.spt, stream, g.threads, g.smem, x0.typed_data(),
                   x1.typed_data(), scal.typed_data(), seed.typed_data(),
                   nullptr, nullptr, nullptr, nullptr, nullptr,
                   x0o->typed_data(), x1o->typed_data(), plaq->typed_data(),
                   chg->typed_data(), prob->typed_data(), g.lt, g.lx, g.k,
                   g.n, g.b));
}

ffi::Error ChainInjected(
    cudaStream_t stream, ffi::Buffer<ffi::F32> x0, ffi::Buffer<ffi::F32> x1,
    ffi::Buffer<ffi::F32> scal, ffi::Buffer<ffi::F32> v0s,
    ffi::Buffer<ffi::F32> v1s, ffi::Buffer<ffi::F32> us,
    ffi::Buffer<ffi::F32> nus, ffi::Buffer<ffi::F32> uhs,
    ffi::ResultBuffer<ffi::F32> x0o, ffi::ResultBuffer<ffi::F32> x1o,
    ffi::ResultBuffer<ffi::F32> plaq, ffi::ResultBuffer<ffi::F32> chg,
    ffi::ResultBuffer<ffi::F32> prob, int64_t lt, int64_t lx,
    int64_t num_leapfrog, int64_t hop, int64_t threads, int64_t spt,
    int64_t smem) {
  const auto xd = x0.dimensions();
  const auto td = plaq->dimensions();
  Geometry g{static_cast<int>(lt), static_cast<int>(lx),
             static_cast<int>(num_leapfrog), static_cast<int>(td[0]),
             static_cast<int>(xd[0]), static_cast<int>(threads),
             static_cast<int>(spt), static_cast<size_t>(smem)};
  ffi::Error e = check_geometry(g, xd, td);
  if (e.failure()) return e;
  if (v0s.element_count() != static_cast<size_t>(g.n) * g.b * g.lt * g.lx ||
      us.element_count() != static_cast<size_t>(g.n) * g.b) {
    return ffi::Error::InvalidArgument("u1 chain: bad randomness shapes");
  }
  auto* fn = hop ? launch<true, true> : launch<false, true>;
  return finish(fn(g.spt, stream, g.threads, g.smem, x0.typed_data(),
                   x1.typed_data(), scal.typed_data(), nullptr,
                   v0s.typed_data(), v1s.typed_data(), us.typed_data(),
                   nus.typed_data(), uhs.typed_data(), x0o->typed_data(),
                   x1o->typed_data(), plaq->typed_data(), chg->typed_data(),
                   prob->typed_data(), g.lt, g.lx, g.k, g.n, g.b));
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    L2hmcU1ChainPhilox, ChainPhilox,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::U32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int64_t>("lt")
        .Attr<int64_t>("lx")
        .Attr<int64_t>("num_leapfrog")
        .Attr<int64_t>("hop")
        .Attr<int64_t>("threads")
        .Attr<int64_t>("spt")
        .Attr<int64_t>("smem"));

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    L2hmcU1ChainInjected, ChainInjected,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int64_t>("lt")
        .Attr<int64_t>("lx")
        .Attr<int64_t>("num_leapfrog")
        .Attr<int64_t>("hop")
        .Attr<int64_t>("threads")
        .Attr<int64_t>("spt")
        .Attr<int64_t>("smem"));
