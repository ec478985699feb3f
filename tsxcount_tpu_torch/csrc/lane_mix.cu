// The lane-mix bijection of k-mer keys, forward and inverse.
//
// Replaces no Pallas kernel: the JAX package's LaneMixBijection._apply_cols
// (tsxcount_tpu/ops/mix.py) is elementwise jnp code that XLA fuses into one
// pass on the TPU.  Eager PyTorch would run it as several hundred launches
// a batch, so here it is one kernel: a thread takes one position, loads its
// L lanes into registers, runs the three XOR-Feistel half-rounds
//     hi ^= F(lo, 1);  lo ^= F(hi, 2);  hi ^= F(lo, 3)
// (inverse: the same in reverse order) over lo = lanes [0, L/2) and hi =
// lanes [L/2, L), and stores the L image lanes.  F folds its inputs into two
// accumulators and draws each output through a murmur3 finalizer; the salt
// picks the multipliers, and with the lane count a template parameter every
// multiplier is a constant in the instruction stream.  The top lane's F
// output is masked to the key's top bits.  A single-lane key (k <= 16)
// takes multiply/xorshift rounds modulo 2^2k instead, with run-time
// multipliers (odd, and their inverses modulo 2^2k).
//
// Bound: device-memory bandwidth.  Each lane word is read once and written
// once (8 B a lane a position, coalesced: neighbouring threads on
// neighbouring positions of every column); about 12 integer operations a
// lane a half-round stay far below the card's rate.
//
// Contract (ops/mix.py lane_mix): L (1..16) int32 input columns of n rows,
// lsb lane first, and L output columns; out gets the image (inverse: the
// preimage) of every row, bit for bit the plain version's.

#include "common.cuh"

namespace tsx {
namespace {

constexpr int kMixThreads = 256;
constexpr int kMaxMixLanes = 16;

__host__ __device__ constexpr uint32_t lane_mult_a(int i) {
  constexpr uint32_t t[18] = {
      0x9E3779B1u, 0x85EBCA77u, 0xC2B2AE3Du, 0x27D4EB2Fu, 0x165667B1u,
      0xD3A2646Du, 0xFD7046C5u, 0xB55A4F09u, 0xCC9E2D51u, 0x1B873593u,
      0xE6546B65u, 0x38495AB5u, 0x7FEB352Du, 0x846CA68Bu, 0x9E3779B9u,
      0xC2B2AE35u, 0x94D049BBu, 0xBF58476Du};
  return t[i % 18];
}

__host__ __device__ constexpr uint32_t lane_mult_b(int i) {
  constexpr uint32_t t[18] = {
      0x2545F491u, 0x6C62272Fu, 0x52DCE729u, 0x38EA70B3u, 0x9FB21C65u,
      0x1D8048FBu, 0xA2AA033Bu, 0x62992FC1u, 0x30BF3847u, 0xAD93481Bu,
      0x4BAE4A77u, 0x85D068E9u, 0x8EE0D535u, 0x16A85F0Fu, 0x5851F42Du,
      0x4C957F2Du, 0xF767814Fu, 0x2127599Bu};
  return t[i % 18];
}

__device__ __forceinline__ uint32_t fmix_g(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// x[OUT0 + j] ^= F_j(x[IN0 .. IN0 + NIN)) for j < NOUT, salt SALT; the last
// output masked by `last_mask`.
template <int L, int IN0, int NIN, int OUT0, int NOUT, int SALT>
__device__ __forceinline__ void half_round(uint32_t (&x)[L],
                                           uint32_t last_mask) {
  uint32_t h1 = 0x9E3779B9u ^ (static_cast<uint32_t>(SALT) * 0x7FEB352Du);
  uint32_t h2 = 0xC2B2AE35u ^ (static_cast<uint32_t>(SALT) * 0x846CA68Bu);
#pragma unroll
  for (int i = 0; i < NIN; ++i) {
    const uint32_t c = x[IN0 + i];
    uint32_t ka = c * lane_mult_a(i + SALT);
    ka ^= ka >> 15;
    uint32_t kb = c * lane_mult_b(i + SALT);
    kb ^= kb >> 17;
    h1 = (h1 ^ ka) * 5u + 0xE6546B64u;
    h2 = (h2 ^ kb) * 5u + 0x38495AB5u;
  }
#pragma unroll
  for (int j = 0; j < NOUT; ++j) {
    uint32_t v = h1 ^ (h2 * lane_mult_a(j + 7 * SALT));
    v = fmix_g(v + lane_mult_b(j + 5 * SALT));
    if (j == NOUT - 1) v &= last_mask;
    x[OUT0 + j] ^= v;
  }
}

// Run-time parameters of the single-lane map (k <= 16).
struct OneLane {
  uint32_t mask, odd1, odd2, inv1, inv2;
  int shift, unshift_steps;
};

__device__ __forceinline__ uint32_t unxorshift(uint32_t y, int s, int steps) {
  uint32_t x = y;
  for (int i = 0; i < steps; ++i) x = y ^ (x >> s);
  return x;
}

__device__ __forceinline__ uint32_t one_lane(uint32_t x, const OneLane& p,
                                             bool inverse) {
  if (!inverse) {
    x = (x * p.odd1) & p.mask;
    x ^= x >> p.shift;
    x = (x * p.odd2) & p.mask;
    return x ^ (x >> p.shift);
  }
  x = unxorshift(x, p.shift, p.unshift_steps);
  x = (x * p.inv2) & p.mask;
  x = unxorshift(x, p.shift, p.unshift_steps);
  return (x * p.inv1) & p.mask;
}

template <int L, bool INV>
__global__ void __launch_bounds__(kMixThreads)
    lane_mix_kernel(ColSet in, ColSet out, int64_t n, uint32_t top_mask,
                    OneLane one) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kMixThreads +
                    threadIdx.x;
  if (i >= n) return;
  uint32_t x[L];
#pragma unroll
  for (int c = 0; c < L; ++c) {
    x[c] = reinterpret_cast<const uint32_t*>(in.p[c])[i];
  }
  if constexpr (L == 1) {
    x[0] = one_lane(x[0], one, INV);
  } else {
    constexpr int H = L / 2;
    if constexpr (!INV) {
      half_round<L, 0, H, H, L - H, 1>(x, top_mask);
      half_round<L, H, L - H, 0, H, 2>(x, 0xFFFFFFFFu);
      half_round<L, 0, H, H, L - H, 3>(x, top_mask);
    } else {
      half_round<L, 0, H, H, L - H, 3>(x, top_mask);
      half_round<L, H, L - H, 0, H, 2>(x, 0xFFFFFFFFu);
      half_round<L, 0, H, H, L - H, 1>(x, top_mask);
    }
  }
#pragma unroll
  for (int c = 0; c < L; ++c) {
    reinterpret_cast<uint32_t*>(out.p[c])[i] = x[c];
  }
}

}  // namespace
}  // namespace tsx

extern "C" int tsx_lane_mix(void* const* in, void* const* out, int lanes,
                            int64_t n, int inverse, uint32_t top_mask,
                            uint32_t odd1, uint32_t odd2, uint32_t inv1,
                            uint32_t inv2, int shift, int unshift_steps,
                            void* stream) {
  using namespace tsx;
  if (lanes < 1 || lanes > kMaxMixLanes || n < 0 || shift < 1) {
    return cudaErrorInvalidValue;
  }
  if (n > 0) {
    int widths[kMaxMixLanes];
    for (int c = 0; c < lanes; ++c) widths[c] = 4;
    const ColSet ci = make_colset(in, widths, lanes);
    const ColSet co = make_colset(out, widths, lanes);
    const OneLane one{top_mask, odd1, odd2, inv1, inv2, shift, unshift_steps};
    const unsigned blocks = static_cast<unsigned>(ceil_div(n, kMixThreads));
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    with_cols<1, kMaxMixLanes>(lanes, [&](auto nl) {
      constexpr int L = decltype(nl)::value;
      if (inverse) {
        lane_mix_kernel<L, true><<<blocks, kMixThreads, 0, st>>>(
            ci, co, n, top_mask, one);
      } else {
        lane_mix_kernel<L, false><<<blocks, kMixThreads, 0, st>>>(
            ci, co, n, top_mask, one);
      }
    });
  }
  return cudaGetLastError();
}
