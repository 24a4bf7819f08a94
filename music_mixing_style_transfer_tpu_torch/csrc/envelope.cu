// Compressor / expander envelope follower for NVIDIA Hopper (sm_90a), as a
// time-parallel scan over the whole card.
//
// Replaces music_mixing_style_transfer_tpu/ops/pallas/envelope.py:
// _envelope_pallas_packed (kernel body _envelope_kernel). For every lane l of
// y [L, T] (row-major float32), reading row rows[l] of x [R, T] (rows[l] = l
// when no rows are given), with per-lane threshold, ratio, a_att, a_rel and
// carried envelope env_in[l]:
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
// The algebra. In the signed form z = s e (s = +1 where a_att <= a_rel, -1
// elsewhere; min(u, v) = -max(-u, -v) and a sign flip is exact) each step is
//
//   z_t = max(a z_{t-1} + p_t, c z_{t-1} + q_t),  a = a_att, c = a_rel,
//   p_t = s (1-a) x_l[t],  q_t = s (1-c) x_l[t],
//
// a map that is increasing in z. Composed over a chunk of C steps it is
// exactly z_out = max_i (A_i z_in + B_i), i = 0..C, with A_i = a^i c^(C-i)
// (i attack steps, any order) and the intercepts from the DP over the steps
//
//   B_i <- max(a B_{i-1} + p_t, c B_i + q_t)   (B_0 = 0 before the first),
//
// about C^2/2 pairs of FMAs, in registers. It is exact in exact arithmetic;
// in float32 the slopes are the only rounding that repeats identically in
// every chunk, so they are taken in double and kept as hi + lo floats
// (z_out = max_i fma(hi_i, z, fma(lo_i, z, B_i))): a slope rounded to float
// alone biases the carry, and the bias adds up over the ~1/(1 - c^C) chunks
// the envelope remembers.
//
// The phases. A block has 8 warps; warp w owns one lane (l = group*8 + w)
// over a window of 32 chunks (32*C samples), one chunk per thread:
//   (A) x goes through the warp's shared-memory tile with coalesced float4
//       loads; each thread takes its chunk's side chain (x_l, kept in
//       registers) and its C+1 intercepts, stored to the tile. Where the
//       block's 8 lanes read one row (rows[l] equal: the normalizer's
//       sweep, 128 candidates a channel), the block stages that row's
//       window and its dB levels once: each log10 is taken once for 8
//       lanes, and x is read once;
//   (B) the carry crosses the window's chunks in order: thread k evaluates
//       piece min(k + 32m, C) on the carry (both slope halves in registers,
//       the next chunk's intercepts read ahead), and one redux.sync takes
//       the max: 32 dependent evaluations replace 32*C dependent steps.
//       Each step is a convex combination of the carry and s*x_l, so where
//       s*env_in and s*x_l have one sign every carry and intercept has it,
//       and the redux runs on the floats' bits (a signed max for >= 0, an
//       unsigned min for <= 0); else on an order-preserving key;
//   (C) each thread re-walks its own chunk from its carry, exactly the serial
//       recurrence over C steps, applies the gain, and y leaves through the
//       tile, coalesced.
// The chain. Block tickets (an atomic counter) are taken in launch order,
// lane group fastest, so a block waits only on one that already runs. A
// window takes its carry from the previous one as one 64-bit word per lane
// (flag | float bits, relaxed store and poll at GPU scope; the poll traps
// after ~2^32 cycles rather than hang the card). Phase A of every resident
// block runs before its wait, so the serial path through a lane is T/C
// piece evaluations and T/(32 C) hand-offs, and the rest fills the card:
// the sweep's [1024, 262144] slab is 65,536 blocks at C = 16 and the final
// [8, 655360] compression 320 blocks at C = 64, against one block of 8
// lanes for the whole signal in the serial design this replaces. Summaries
// never leave the SM; x is read once from device memory and y written once.
// Lanes past L and samples past T are masked, not padded: the last chunk of
// a lane, partial or not, is walked by phase C only, so the carry is exact
// for ragged slabs. Offsets are 64-bit. No fast-math intrinsics: log10f and
// expf are the accurate ones.
//
// The chunk C: a larger C shortens the serial path (T/C evaluations) and
// costs ~1.5 C operations a sample in phase A. chunk_for takes 16 from 128
// lanes on, where the card's work binds (64 registers, four blocks an SM),
// and 64 below, where the serial path does (255 registers, x_l of the chunk
// kept in them). 128 would need x_l taken again in phase C and a long
// single-thread phase A before the chain starts; it was no faster.
//
// Bound: bytes. x read once (R rows) and y written once, (R*T + L*T)*4 B
// over 3.35 TB/s: 0.32 ms at [1024, 262144] read from 8 rows (one slab of
// the normalizer's candidate sweep) and 0.0125 ms at [8, 655360] (its final
// compression). Measured on an NVIDIA H100 80GB HBM3 at 700.00 W
// (chip_smoke.py): 1.22 ms at [1024, 262144] from 8 rows (C = 16) and
// 0.61 ms at [8, 655360] (C = 64), against 2.75 and 6.75 ms for the serial
// kernel this replaces. Both are held by the chain, not the bytes: at
// C = 16 a window every ~2.5 us (phase B ~1.7 us, 53 ns a chunk, and the
// hand-off ~0.7 us), 512 windows a lane; at C = 64 the first window's
// phase A (~30 us) and 320 windows of ~1.7 us. Tuning table and
// per-phase trace: PERF.md, K2 (ops/cuda/k2_variants.py).

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int WARPS = 8;         // lanes a block: warp w owns lane group*8 + w
constexpr int NCH = 32;          // chunks a window: one per thread of a warp
constexpr int THREADS = 32 * WARPS;
constexpr float NEG_LN10_OVER_20 = -0.11512925464970229f;
constexpr unsigned FULL = 0xffffffffu;
constexpr long long SPIN_LIMIT = 1LL << 32;  // cycles (~2 s) before a stuck wait traps

template <int C>
struct Shape {
  static constexpr int WINDOW = NCH * C;
  static constexpr int PITCH = C + 1;  // odd: a thread's row of the tile is conflict-free
  static constexpr int PIECES = (C + 1 + 31) / 32;  // pieces a thread evaluates in phase B
  // per warp, in floats, the tile [NCH][PITCH]: x, then intercepts, then y
  static constexpr int WARP_FLOATS = NCH * PITCH;
  // blocks whose lanes all read one row share its window (x and its dB level,
  // two more tiles) at the chunks taken for many lanes
  static constexpr bool SHARE = C <= 32;
  static constexpr int SMEM = (WARPS + (SHARE ? 2 : 0)) * WARP_FLOATS * 4;
  static constexpr int MIN_BLOCKS = C <= 16 ? 4 : (C <= 32 ? 2 : 1);  // C = 16: 64 registers
};

// The chunk: from FEW_LANES lanes on the card's work binds, so the least work
// a sample; below, the chain does, so the longer chunk (T/C serial evaluations)
constexpr long long FEW_LANES = 128;
constexpr int MANY_LANES_CHUNK = 16;
constexpr int FEW_LANES_CHUNK = 64;

int chunk_for(long long n_lanes) {
  return n_lanes < FEW_LANES ? FEW_LANES_CHUNK : MANY_LANES_CHUNK;
}

__device__ __forceinline__ float level_db(float v) {
  const float ax = fabsf(v);
  return ax < 1e-6f ? -120.0f : 20.0f * log10f(ax);
}

// x_l from the level x_g: the static curve's excess on its active side
__device__ __forceinline__ float curve(float xg, float th, float one_m_inv, int mode) {
  const float over = xg - th;
  const float xlv = over * one_m_inv;
  if (mode > 0) return over >= 0.0f ? xlv : 0.0f;
  if (mode < 0) return over <= 0.0f ? xlv : 0.0f;
  return 0.0f;
}

__device__ __forceinline__ float side_chain(float v, float th, float one_m_inv, int mode) {
  return curve(level_db(v), th, one_m_inv, mode);
}

// order-preserving map of a float to a signed int key (its own inverse): the
// max of the keys is the key of the max
__device__ __forceinline__ int flip_key(int b) { return b ^ ((b >> 31) & 0x7fffffff); }

__device__ __forceinline__ void publish(unsigned long long* p, float z) {
  const unsigned long long word = (1ULL << 32) | __float_as_uint(z);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word) : "memory");
}

__device__ __forceinline__ float wait_carry(const unsigned long long* p) {
  unsigned long long word;
  const long long start = clock64();
  while (true) {
    asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(word) : "l"(p) : "memory");
    if (word >> 32) break;
    if (clock64() - start > SPIN_LIMIT) __trap();
  }
  return __uint_as_float(static_cast<unsigned>(word));
}

// One window of one lane, by one warp. SHARED: the block's 8 lanes read one
// row, whose window the block stages once (x and its dB level) for all.
template <int C, bool SHARED>
__device__ __forceinline__ void scan_window(
    const float* __restrict__ x, const long long* __restrict__ rows, long long n_rows,
    const float* __restrict__ threshold, const float* __restrict__ ratio,
    const float* __restrict__ a_att, const float* __restrict__ a_rel,
    const float* __restrict__ env_in, float* __restrict__ y, float* __restrict__ env_out,
    unsigned long long* __restrict__ status, long long n_lanes, long long t_len, int vec,
    long long win, long long lane) {
  using S = Shape<C>;
  constexpr int P = S::PITCH;
  extern __shared__ float4 smem4[];

  const int tid = threadIdx.x;
  const int warp = tid >> 5, k = tid & 31;
  const long long n_win = (t_len + S::WINDOW - 1) / S::WINDOW;
  const bool last_win = win == n_win - 1;

  float* tile = reinterpret_cast<float*>(smem4) + static_cast<size_t>(warp) * S::WARP_FLOATS;
  float* xs = reinterpret_cast<float*>(smem4) + WARPS * S::WARP_FLOATS;  // SHARED: x,
  float* gs = xs + S::WARP_FLOATS;                                       // then its level

  const float th = threshold[lane];
  const float r = ratio[lane];
  const int mode = r > 1.0f ? 1 : (r < 1.0f ? -1 : 0);
  const float one_m_inv = 1.0f - (r > 1.0f ? 1.0f / r : r);
  const float aa = a_att[lane], ar = a_rel[lane];
  const float s = aa <= ar ? 1.0f : -1.0f;
  const float ba = s * (1.0f - aa), br = s * (1.0f - ar);
  long long row = lane;
  if (rows != nullptr) {
    row = rows[lane];
    if (row < 0 || row >= n_rows) __trap();  // an index outside x: an error, not a read
  }
  const float* xr = x + row * t_len;
  float* yr = y + lane * t_len;
  const long long w0 = win * S::WINDOW;
  const long long t0 = w0 + static_cast<long long>(k) * C;
  const int n = static_cast<int>(t_len - t0 < C ? (t_len - t0 > 0 ? t_len - t0 : 0) : C);
  const bool full = n == C;
  const bool vec_win = vec && w0 + S::WINDOW <= t_len;

  // the window's x into the tile, coalesced (thread k's chunk is row k)
  auto stage_x = [&]() {
    if (vec_win) {
      const float4* src = reinterpret_cast<const float4*>(xr + w0);
#pragma unroll
      for (int q = k; q < S::WINDOW / 4; q += 32) {
        const float4 v = __ldg(src + q);
        float* d = tile + (4 * q / C) * P + 4 * q % C;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
    } else {
      for (int e = k; e < S::WINDOW; e += 32) {
        tile[(e / C) * P + e % C] = w0 + e < t_len ? __ldg(xr + w0 + e) : 0.0f;
      }
    }
    __syncwarp();
  };

  // ---- (A) side chain and the chunk's intercepts ----
  if constexpr (SHARED) {  // the row's window once for the block, its log10 split 8 ways
    for (int e = tid; e < S::WINDOW; e += THREADS) {
      const float v = w0 + e < t_len ? __ldg(xr + w0 + e) : 0.0f;
      const int o = (e / C) * P + e % C;
      xs[o] = v;
      gs[o] = level_db(v);
    }
    __syncthreads();  // all 8 lanes are valid here: no warp of the block has left
  } else {
    stage_x();
  }
  float xl[C];  // x_l of this thread's chunk, in registers for phases A and C
  const float* mine_x = tile + k * P;
#pragma unroll
  for (int q = 0; q < C; ++q) {
    const float u = SHARED ? curve(gs[k * P + q], th, one_m_inv, mode)
                           : side_chain(mine_x[q], th, one_m_inv, mode);
    xl[q] = q < n ? u : 0.0f;
  }
  if (full) {  // a partial chunk is the lane's last: phase C walks it
    float b[C + 1];
    b[0] = 0.0f;
#pragma unroll
    for (int t = 0; t < C; ++t) {
      const float v = xl[t];
      const float p = ba * v, q = br * v;
      b[t + 1] = fmaf(aa, b[t], p);
#pragma unroll
      for (int i = t; i >= 1; --i) b[i] = fmaxf(fmaf(aa, b[i - 1], p), fmaf(ar, b[i], q));
      b[0] = fmaf(ar, b[0], q);
    }
    float* mine = tile + k * P;  // a thread's own row: x read, intercepts written
#pragma unroll
    for (int i = 0; i <= C; ++i) mine[i] = b[i];
  }
  __syncwarp();

  // ---- (B) the carry across the window's chunks ----
  // this thread's pieces i = min(k + 32 m, C) (threads past C repeat piece C,
  // which leaves the max as it is); slopes a^i c^(C-i) in double, as hi + lo
  float s_hi[S::PIECES], s_lo[S::PIECES];
#pragma unroll
  for (int m = 0; m < S::PIECES; ++m) {
    const int i = min(k + 32 * m, C);
    double v = 1.0;
#pragma unroll
    for (int u = 0; u < C; ++u) v *= u < i ? static_cast<double>(aa) : static_cast<double>(ar);
    s_hi[m] = static_cast<float>(v);
    s_lo[m] = static_cast<float>(v - static_cast<double>(s_hi[m]));
  }
  // chunks this window evaluates: all 32, or in the last window all but the
  // lane's last valid one (whose carry out, env_out, phase C produces)
  const int n_valid = static_cast<int>((t_len - w0 + C - 1) / C < NCH ? (t_len - w0 + C - 1) / C : NCH);
  const int n_eval = last_win ? n_valid - 1 : NCH;
  float bc[S::PIECES], bn[S::PIECES];
#pragma unroll
  for (int m = 0; m < S::PIECES; ++m) bc[m] = n_eval > 0 ? tile[min(k + 32 * m, C)] : 0.0f;
  // Each step is a convex combination of the carry and s*x_l, so where
  // s*env_in and s*x_l (of the curve's side, s*mode) have one sign, every
  // carry and intercept has it too, and the max is a redux on the floats'
  // bits: a signed max where they are >= 0 (-0 is the least key), an
  // unsigned min where <= 0 (+0 the least). Else on an order-preserving key.
  const float z_in = s * env_in[lane];
  const float x_sign = s * static_cast<float>(mode);
  const int cls = x_sign >= 0.0f && z_in >= 0.0f ? 1 : (x_sign <= 0.0f && z_in <= 0.0f ? -1 : 0);
  float z = z_in;
  if (win > 0) {
    float got = 0.0f;
    if (k == 0) got = wait_carry(status + 1 + (win - 1) * n_lanes + lane);
    z = __shfl_sync(FULL, got, 0);
  }
  float my_z = z;  // the carry into this thread's chunk
  auto scan = [&](auto cls_tag) {  // the chunks in order, one redux each
    constexpr int CLS = decltype(cls_tag)::value;
    for (int j = 0; j < n_eval; ++j) {
      if (k == j) my_z = z;
#pragma unroll
      for (int m = 0; m < S::PIECES; ++m) {  // the next chunk's intercepts, read ahead
        bn[m] = j + 1 < n_eval ? tile[(j + 1) * P + min(k + 32 * m, C)] : 0.0f;
      }
      float v = fmaf(s_hi[0], z, fmaf(s_lo[0], z, bc[0]));
#pragma unroll
      for (int m = 1; m < S::PIECES; ++m) v = fmaxf(v, fmaf(s_hi[m], z, fmaf(s_lo[m], z, bc[m])));
      if constexpr (CLS > 0) {
        z = __int_as_float(__reduce_max_sync(FULL, __float_as_int(v)));
      } else if constexpr (CLS < 0) {
        z = __uint_as_float(__reduce_min_sync(FULL, __float_as_uint(v)));
      } else {
        z = __int_as_float(flip_key(__reduce_max_sync(FULL, flip_key(__float_as_int(v)))));
      }
#pragma unroll
      for (int m = 0; m < S::PIECES; ++m) bc[m] = bn[m];
    }
  };
  if (cls > 0) {
    scan(std::integral_constant<int, 1>{});
  } else if (cls < 0) {
    scan(std::integral_constant<int, -1>{});
  } else {
    scan(std::integral_constant<int, 0>{});
  }
  if (k == n_eval) my_z = z;
  if (!last_win && k == 0) publish(status + 1 + win * n_lanes + lane, z);
  __syncwarp();  // the intercepts are read: the tile takes x again, then y

  // ---- (C) re-walk each chunk from its carry, gain, store coalesced ----
  if constexpr (!SHARED) stage_x();
  if (n > 0) {
    float zz = my_z;
    float* mine = tile + k * P;
#pragma unroll
    for (int q = 0; q < C; ++q) {
      if (q < n) {
        const float v = SHARED ? xs[k * P + q] : mine[q], u = xl[q];
        zz = fmaxf(fmaf(aa, zz, ba * u), fmaf(ar, zz, br * u));
        mine[q] = v * expf(NEG_LN10_OVER_20 * (s * zz));
      }
    }
    if (last_win && k == n_valid - 1) env_out[lane] = s * zz;
  }
  __syncwarp();
  if (vec_win) {
    float4* dst = reinterpret_cast<float4*>(yr + w0);
#pragma unroll
    for (int q = k; q < S::WINDOW / 4; q += 32) {
      const float* d = tile + (4 * q / C) * P + 4 * q % C;
      dst[q] = make_float4(d[0], d[1], d[2], d[3]);
    }
  } else {
    for (int e = k; e < S::WINDOW && w0 + e < t_len; e += 32) yr[w0 + e] = tile[(e / C) * P + e % C];
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS, Shape<C>::MIN_BLOCKS) envelope_scan_kernel(
    const float* __restrict__ x, const long long* __restrict__ rows, long long n_rows,
    const float* __restrict__ threshold, const float* __restrict__ ratio,
    const float* __restrict__ a_att, const float* __restrict__ a_rel,
    const float* __restrict__ env_in, float* __restrict__ y, float* __restrict__ env_out,
    unsigned long long* __restrict__ status, long long n_lanes, long long t_len, int vec) {
  __shared__ unsigned s_ticket;
  if (threadIdx.x == 0) s_ticket = atomicAdd(reinterpret_cast<unsigned*>(status), 1u);
  __syncthreads();
  const long long groups = (n_lanes + WARPS - 1) / WARPS;
  const long long win = static_cast<long long>(s_ticket) / groups;
  const long long first = static_cast<long long>(s_ticket) % groups * WARPS;
  const long long lane = first + (threadIdx.x >> 5);
  if constexpr (Shape<C>::SHARE) {
    const bool shared_row =
        __syncthreads_and(rows != nullptr && lane < n_lanes && rows[lane] == rows[first]);
    if (lane >= n_lanes) return;
    // from here the only block-wide barrier is the shared window's: warps
    // are otherwise independent
    if (shared_row) {
      scan_window<C, true>(x, rows, n_rows, threshold, ratio, a_att, a_rel, env_in, y, env_out,
                           status, n_lanes, t_len, vec, win, lane);
      return;
    }
  }
  if (lane >= n_lanes) return;
  scan_window<C, false>(x, rows, n_rows, threshold, ratio, a_att, a_rel, env_in, y, env_out,
                        status, n_lanes, t_len, vec, win, lane);
}

// 64-bit words of scratch a launch needs (zeroed by the caller): the block
// ticket and one carry word per lane for every window but the last
long long scratch_words(long long n_lanes, long long t_len) {
  const long long window = static_cast<long long>(NCH) * chunk_for(n_lanes);
  return 1 + ((t_len + window - 1) / window - 1) * n_lanes;
}

template <int C>
int launch(const float* x, const long long* rows, long long n_rows, const float* threshold,
           const float* ratio, const float* a_att, const float* a_rel, const float* env_in,
           float* y, float* env_out, unsigned long long* status, long long status_words,
           long long n_lanes, long long t_len, cudaStream_t stream) {
  using S = Shape<C>;
  const long long groups = (n_lanes + WARPS - 1) / WARPS;
  const long long n_win = (t_len + S::WINDOW - 1) / S::WINDOW;
  if (groups * n_win > 0x7fffffffLL || status_words < scratch_words(n_lanes, t_len)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S::SMEM > 48 * 1024) {  // above 48 KB of shared memory only after opting in
    const cudaError_t err = cudaFuncSetAttribute(
        envelope_scan_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int vec = t_len % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                  reinterpret_cast<uintptr_t>(y) % 16 == 0;
  envelope_scan_kernel<C><<<static_cast<unsigned>(groups * n_win), THREADS, S::SMEM, stream>>>(
      x, rows, n_rows, threshold, ratio, a_att, a_rel, env_in, y, env_out, status, n_lanes, t_len,
      vec);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The chunk length that compressor_envelope_f32 takes for n_lanes lanes.
extern "C" int compressor_envelope_chunk(long long n_lanes) { return chunk_for(n_lanes); }

// 64-bit words of zeroed scratch that compressor_envelope_f32 takes.
extern "C" long long compressor_envelope_scratch_words(long long n_lanes, long long t_len) {
  return scratch_words(n_lanes, t_len);
}

// x: [n_rows, t_len] row-major float32; rows: [n_lanes] int64 (lane l reads
// row rows[l]), or null for rows[l] = l; y: [n_lanes, t_len]; threshold,
// ratio, a_att, a_rel, env_in, env_out: [n_lanes] float32; status: zeroed
// scratch of compressor_envelope_scratch_words 64-bit words. Launches on
// `stream` and returns cudaGetLastError(), or cudaErrorInvalidValue for what
// it does not take.
extern "C" int compressor_envelope_f32(const void* x, const void* rows, long long n_rows,
                                       const void* threshold, const void* ratio,
                                       const void* a_att, const void* a_rel, const void* env_in,
                                       void* y, void* env_out, void* status,
                                       long long status_words, long long n_lanes,
                                       long long t_len, void* stream) {
  if (n_lanes < 1 || t_len < 1 || n_rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* xf = static_cast<const float*>(x);
  const auto* rl = static_cast<const long long*>(rows);
  const auto* th = static_cast<const float*>(threshold);
  const auto* ra = static_cast<const float*>(ratio);
  const auto* aa = static_cast<const float*>(a_att);
  const auto* ar = static_cast<const float*>(a_rel);
  const auto* ei = static_cast<const float*>(env_in);
  auto* yf = static_cast<float*>(y);
  auto* eo = static_cast<float*>(env_out);
  auto* st = static_cast<unsigned long long*>(status);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_lanes < FEW_LANES) {
    return launch<FEW_LANES_CHUNK>(xf, rl, n_rows, th, ra, aa, ar, ei, yf, eo, st, status_words,
                                   n_lanes, t_len, s);
  }
  return launch<MANY_LANES_CHUNK>(xf, rl, n_rows, th, ra, aa, ar, ei, yf, eo, st, status_words,
                                  n_lanes, t_len, s);
}
