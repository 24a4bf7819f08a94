// Compressor / expander envelope follower for NVIDIA Hopper (sm_90a).
//
// Replaces music_mixing_style_transfer_tpu/ops/pallas/envelope.py:
// _envelope_pallas_packed (kernel body _envelope_kernel). For every lane l of
// x [L, T] (row-major float32) with per-lane threshold, ratio, a_att, a_rel
// and carried envelope env_in[l]:
//
//   x_g  = |x| < 1e-6 ? -120 : 20 log10|x|                      (dB side chain)
//   over = x_g - threshold
//   x_l  = over * (1 - inv_ratio) on the curve's active side, else 0
//          (ratio > 1: compress above threshold, inv_ratio = 1/ratio;
//           ratio < 1: expand below threshold, inv_ratio = ratio; ratio 1: 0)
//   e[t] = max(a_att e[t-1] + (1-a_att) x_l[t], a_rel e[t-1] + (1-a_rel) x_l[t])
//          (min instead of max where a_att > a_rel), e[-1] = env_in[l]
//   y    = x * 10^(-e/20) = x * exp(-0.1151292546 e)
//
// and env_out[l] = e[T-1], so feeding consecutive slabs with the carry equals
// one pass over the whole signal, for any slab length. This is the Pallas
// kernel's side-chain and gain form; the plain version (ops/cuda/envelope.py)
// follows ops/compressor.py:compressor_process instead.
//
// Design. What bounds the work is the bytes (x read once, y written once:
// 2*L*T*4 B) and, above all, the serial chain in time: each lane's T steps
// depend on each other, one FMA and one max each. A block owns LANES = 8
// lanes and walks time in chunks of CHUNK = 128 samples through a ring of
// STAGES = 3 shared-memory tiles [LANES][CHUNK + 1] (the +1 keeps the serial
// walk, which reads down the lanes, free of bank conflicts). Warp 0 walks the
// chain; its thread l owns lane l, keeps the envelope in a register across
// chunks and stages the tile's values in registers a group of 16 steps ahead,
// so no shared-memory latency sits on the chain. Eight worker warps (256
// threads, each on one sample of 4 of the 8 lanes, so their global reads and
// writes are coalesced rows) run the elementwise work around it: in the step in which warp 0 walks chunk i they
// compute the side chain of chunk i+1 into the next tile, start the global
// loads of chunk i+2 into registers, and apply the gain of chunk i-1 from its
// walked tile and the x they still hold in registers. One barrier per chunk.
// The signed form min(a, b) = -max(-a, -b) (a sign flip is exact) keeps the
// walk branch-free for lanes of either ordering of a_att and a_rel: the chain
// is one FMA and one FMNMX per step. Lanes past L and samples past T are
// masked (no padding to the TPU's 1024 lanes or to a chunk multiple), so the
// carry is exact for ragged slab lengths. No fast-math intrinsics: log10f and
// expf are the accurate ones. Offsets are 64-bit.
//
// Bound: bytes. 2*L*T*4 B over 3.35 TB/s is 0.64 ms at [1024, 262144] (one
// slab of the normalizer's candidate sweep) and 0.013 ms at [8, 655360] (its
// final compression). The serial chain has its own floor, T dependent steps
// of at least ~8 cycles (FMA then FMNMX) whatever the lane count: ~1.1 ms at
// T = 262144 and ~2.7 ms at T = 655360 near 1.98 GHz, so the chain, not the
// bytes, sets this kernel's time at the normalizer's shapes.
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 (700 W limit):
// 2.77 ms at [1024, 262144] (10.6 ns a step, 4.3x the bytes bound) and
// 6.80 ms at [8, 655360] (10.4 ns a step, ~20 cycles). Details in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LANES = 8;       // lanes per block (warp 0's threads 0..7)
constexpr int CHUNK = 128;     // samples per pipeline stage
constexpr int STAGES = 3;      // gain of i-1, walk of i, side chain of i+1
constexpr int PITCH = CHUNK + 1;
constexpr int GROUP = 16;      // walk steps staged in registers at a time
constexpr int WORKERS = 2 * CHUNK;                         // 8 warps
constexpr int LANES_PER_WORKER = LANES * CHUNK / WORKERS;  // 4 lanes of one sample
constexpr int THREADS = 32 + WORKERS;                      // warp 0 walks, 1-8 work
constexpr float NEG_LN10_OVER_20 = -0.11512925464970229f;

__device__ __forceinline__ float side_chain(float v, float th, float one_m_inv, int mode) {
  const float ax = fabsf(v);
  const float xg = ax < 1e-6f ? -120.0f : 20.0f * log10f(ax);
  const float over = xg - th;
  const float xlv = over * one_m_inv;
  if (mode > 0) return over >= 0.0f ? xlv : 0.0f;
  if (mode < 0) return over <= 0.0f ? xlv : 0.0f;
  return 0.0f;
}

__global__ void __launch_bounds__(THREADS) envelope_kernel(
    const float* __restrict__ x, const float* __restrict__ threshold,
    const float* __restrict__ ratio, const float* __restrict__ a_att,
    const float* __restrict__ a_rel, const float* __restrict__ env_in,
    float* __restrict__ y, float* __restrict__ env_out, long long n_lanes, long long t_len) {
  __shared__ float tile[STAGES][LANES][PITCH];  // x_l, overwritten by the envelope
  __shared__ float s_th[LANES], s_one_m_inv[LANES];
  __shared__ int s_mode[LANES];

  const int tid = threadIdx.x;
  const long long lane0 = static_cast<long long>(blockIdx.x) * LANES;
  const long long n_chunks = (t_len + CHUNK - 1) / CHUNK;

  if (tid < LANES) {
    const long long lane = lane0 + tid;
    const float th = lane < n_lanes ? threshold[lane] : 0.0f;
    const float r = lane < n_lanes ? ratio[lane] : 1.0f;
    s_th[tid] = th;
    s_mode[tid] = r > 1.0f ? 1 : (r < 1.0f ? -1 : 0);
    s_one_m_inv[tid] = 1.0f - (r > 1.0f ? 1.0f / r : r);
  }
  __syncthreads();

  if (tid < 32) {
    // ---- warp 0: the serial walk, thread l on lane l ----
    const long long lane = lane0 + tid;
    const bool live = tid < LANES && lane < n_lanes;
    const float aa = live ? a_att[lane] : 0.0f;
    const float ar = live ? a_rel[lane] : 0.0f;
    const float s = aa <= ar ? 1.0f : -1.0f;  // signed form: max of s * candidates
    const float ba = s * (1.0f - aa);
    const float br = s * (1.0f - ar);
    float z = live ? s * env_in[lane] : 0.0f;
    const int l = tid < LANES ? tid : 0;
    __syncthreads();  // the workers' prologue: chunk 0's side chain
    for (long long i = 0; i <= n_chunks; ++i) {
      if (i < n_chunks && tid < LANES) {
        float* row = tile[i % STAGES][l];
        const long long left = t_len - i * CHUNK;
        if (left >= CHUNK) {
          // the tile's values go to registers a group ahead of the chain, so
          // no shared-memory latency sits between two dependent steps
          float cur[GROUP], nxt[GROUP];
#pragma unroll
          for (int k = 0; k < GROUP; ++k) cur[k] = row[k];
#pragma unroll
          for (int g = 0; g < CHUNK / GROUP; ++g) {
            if (g + 1 < CHUNK / GROUP) {
#pragma unroll
              for (int k = 0; k < GROUP; ++k) nxt[k] = row[(g + 1) * GROUP + k];
            }
#pragma unroll
            for (int k = 0; k < GROUP; ++k) {
              z = fmaxf(fmaf(aa, z, ba * cur[k]), fmaf(ar, z, br * cur[k]));
              cur[k] = s * z;
            }
#pragma unroll
            for (int k = 0; k < GROUP; ++k) row[g * GROUP + k] = cur[k];
#pragma unroll
            for (int k = 0; k < GROUP; ++k) cur[k] = nxt[k];
          }
        } else {
          for (int t = 0; t < static_cast<int>(left); ++t) {
            const float xl = row[t];
            z = fmaxf(fmaf(aa, z, ba * xl), fmaf(ar, z, br * xl));
            row[t] = s * z;
          }
        }
      }
      __syncthreads();
    }
    if (live) env_out[lane] = s * z;
    return;
  }

  // ---- warps 1-8: side chain ahead of the walk, gain behind it ----
  const int wt = tid - 32;
  const int w = wt % CHUNK;                            // sample in the chunk
  const int jb = wt / CHUNK * LANES_PER_WORKER;        // first of its lanes
  float raw[LANES_PER_WORKER] = {}, x_cur[LANES_PER_WORKER] = {};
  float x_next[LANES_PER_WORKER] = {}, x_prev[LANES_PER_WORKER] = {};
  auto load = [&](long long c) {
    const long long t = c * CHUNK + w;
#pragma unroll
    for (int j = 0; j < LANES_PER_WORKER; ++j) {
      const long long lane = lane0 + jb + j;
      raw[j] = (lane < n_lanes && t < t_len) ? __ldg(x + lane * t_len + t) : 0.0f;
    }
  };
  auto prelude = [&](long long c) {
    float(*dst)[PITCH] = tile[c % STAGES];
#pragma unroll
    for (int j = 0; j < LANES_PER_WORKER; ++j) {
      const int l = jb + j;
      dst[l][w] = side_chain(raw[j], s_th[l], s_one_m_inv[l], s_mode[l]);
    }
  };

  if (n_chunks > 0) {
    load(0);
    prelude(0);
#pragma unroll
    for (int j = 0; j < LANES_PER_WORKER; ++j) x_cur[j] = raw[j];
    if (n_chunks > 1) load(1);
  }
  __syncthreads();  // chunk 0's side chain is in place for the walk
  for (long long i = 0; i <= n_chunks; ++i) {
    if (i + 1 < n_chunks) {
      prelude(i + 1);
#pragma unroll
      for (int j = 0; j < LANES_PER_WORKER; ++j) x_next[j] = raw[j];
      if (i + 2 < n_chunks) load(i + 2);
    }
    if (i >= 1) {
      const long long t = (i - 1) * CHUNK + w;
      const float(*env)[PITCH] = tile[(i - 1) % STAGES];
      if (t < t_len) {
#pragma unroll
        for (int j = 0; j < LANES_PER_WORKER; ++j) {
          const long long lane = lane0 + jb + j;
          if (lane < n_lanes) {
            y[lane * t_len + t] = x_prev[j] * expf(NEG_LN10_OVER_20 * env[jb + j][w]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < LANES_PER_WORKER; ++j) {
      x_prev[j] = x_cur[j];
      x_cur[j] = x_next[j];
    }
    __syncthreads();
  }
}

}  // namespace

// x, y: [n_lanes, t_len] row-major float32; threshold, ratio, a_att, a_rel,
// env_in, env_out: [n_lanes] float32. Launches on `stream` and returns
// cudaGetLastError(), or cudaErrorInvalidValue for sizes it does not take.
extern "C" int compressor_envelope_f32(const void* x, const void* threshold, const void* ratio,
                                       const void* a_att, const void* a_rel, const void* env_in,
                                       void* y, void* env_out, long long n_lanes, long long t_len,
                                       void* stream) {
  if (n_lanes < 1 || t_len < 1) return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (n_lanes + LANES - 1) / LANES;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  envelope_kernel<<<static_cast<unsigned>(blocks), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(threshold),
      static_cast<const float*>(ratio), static_cast<const float*>(a_att),
      static_cast<const float*>(a_rel), static_cast<const float*>(env_in),
      static_cast<float*>(y), static_cast<float*>(env_out), n_lanes, t_len);
  return static_cast<int>(cudaGetLastError());
}
