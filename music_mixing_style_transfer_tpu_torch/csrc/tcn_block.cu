// Fused MixFXcloner block for NVIDIA Hopper (sm_90a).
//
// Replaces music_mixing_style_transfer_tpu/ops/pallas/tcn_block.py:fused_tcn_block
// (pallas_call at :201). One pass over device memory computes, for
// channels-last x [B, T, 128]:
//
//   y[b,t,o] = lrelu(sum_k sum_i x[b, t+(k-7)d, i] * w[k][i][o] * s[o] + tt[o], 0.01)
//              * r[b,o] + fb[b,o] + x[b,t,o] * wr[o]
//
// i.e. a 15-tap dilated conv with zero padding of 7*d on each side, eval BN
// folded to (s, tt), FiLM (r, fb) per batch row, and the per-channel grouped
// 1x1 residual wr. Accumulation and the epilogue are float32.
//
// Design: an implicit GEMM on the tensor cores, one skeleton for both types.
// - Tiles of BM time rows of one batch row x all 128 output channels (BM =
//   256 in bf16, 128 in float32). The GEMM's K runs over the live taps x 128
//   input channels, in stages of one 128-byte channel chunk (64 bf16 or 32
//   float32 channels).
// - TMA loads both operands into a ring of 4 stages in shared memory,
//   128-byte swizzled. x goes through a 3-D tensor map over [B, T, C]: tap k
//   of the tile at t0 is the box at row t0 + (k-7)*d, and TMA zero-fills the
//   rows outside [0, T), which is the conv's zero padding. w comes as
//   w_t[k][out][in] (K-major, laid out by the wrapper) through a 2-D map.
// - Warp specialisation: one producer warp keeps the ring full (full/empty
//   mbarrier pairs); two consumer warpgroups each own BM/2 of the tile's
//   rows and issue wgmma m64n128 with the accumulators in registers.
//   setmaxnreg moves registers from the producer warpgroup to the consumers.
// - Persistent grid: one CTA per SM; CTA i takes tiles i, i+G, ... in time
//   order, so the tap windows of the tiles in flight share L2. The producer
//   runs ahead into the next tile's stages while the consumers apply the
//   epilogue (BN affine, LeakyReLU, FiLM, residual) in registers and store.
// - Dead taps are skipped: tap k of a tile is live unless its rows lie
//   wholly outside [0, T). The live taps form one contiguous range that the
//   producer and the consumers compute alike; tap 7 is always live.
// - bfloat16: wgmma m64n128k16, both operands from shared memory.
// - float32: 3xTF32 on wgmma m64n128k8. The wrapper splits w into
//   w_big = tf32(w) and w_small = tf32(w - w_big), rounded to nearest (ties
//   away) explicitly; the consumers load x from shared memory into
//   registers and split it the same way with cvt.rna.tf32, and each k-step
//   issues small*big, big*small and big*big. Each product of two tf32 values
//   is exact in float32; what is dropped is small*small (~2^-22 of a term).
//   The tensor cores' float32 accumulation is not round-to-nearest, so each
//   stage's products are summed in a zeroed register tile and added to the
//   accumulator in float32; that needs the registers of BM = 128. The result
//   has float32's accuracy, measured against float64 in PERF.md. (The TPU
//   gets float32 the same way: its MXU builds a float32 product from several
//   bf16 passes.)
//
// Bound: tensor-core operations. One launch at [4, 2^19, 128] is about
// 1.02e12 operations (2 per multiply-add) on the taps inside [0, T): 1.03 ms
// at the H100 SXM's 989 TFLOP/s bf16 peak; float32 runs 3 TF32 passes at
// 495 TFLOP/s, 6.19 ms (15.25 ms on the CUDA cores at 67 TFLOP/s). It moves
// 1.07 GB in bf16 and 2.15 GB in float32 (0.32 and 0.64 ms at 3.35 TB/s).
// L2 -> shared-memory traffic, derived from the tiling (not measured):
// every tile reads each live tap's x rows and w chunk(s), 12.1 GB per bf16
// launch and 48.3 GB per float32 launch at [4, 2^19, 128].
//
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, per launch, mean of the 11 dilations 8...8192 (bound beside it):
//   [4, 2^19, 128]:     float32 7.68 ms (6.19), bfloat16 1.86 ms (1.03)
//   [128, 17477, 128]:  float32 6.62 ms (5.20), bfloat16 1.73 ms (0.89)
// cuDNN's F.conv1d alone (TF32 off) takes 23.56 / 3.39 and 25.07 / 3.54 ms
// there. PERF.md section 6 keeps these with the earlier kernel's times.

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from the runtime's entry point
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int C = 128;
constexpr int TAPS = 15;
constexpr int HALF = TAPS / 2;
constexpr int CONSUMERS = 2;            // consumer warpgroups, BM / 2 rows each
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int ROW_BYTES = 128;          // one channel chunk: the B128 swizzle width
constexpr int W_BYTES = C * ROW_BYTES;   // w box of one stage (per part)
constexpr int RELEASERS = CONSUMERS * 4;  // one arrive per consumer warp frees a stage
constexpr int CONSUMER_REGS = 232;      // setmaxnreg: consumers take what the producer gives up
constexpr int PRODUCER_REGS = 40;
constexpr float SLOPE = 0.01f;

template <typename T>
struct Cfg;
template <>
struct Cfg<__nv_bfloat16> {
  static constexpr int BM = 256;    // time rows per tile
  static constexpr int STAGES = 4;
  static constexpr int CH = 64;     // channels per stage
  static constexpr int PARTS = 1;   // w
  static constexpr CUtensorMapDataType DT = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
};
template <>
struct Cfg<float> {
  static constexpr int BM = 128;    // 64 rows a warpgroup: room for the per-stage sums
  static constexpr int STAGES = 4;
  static constexpr int CH = 32;
  static constexpr int PARTS = 2;   // w_big, w_small
  static constexpr CUtensorMapDataType DT = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
};

template <typename T>
__host__ __device__ constexpr int x_bytes() { return Cfg<T>::BM * ROW_BYTES; }  // x box of a stage

template <typename T>
__host__ __device__ constexpr int stage_bytes() { return x_bytes<T>() + Cfg<T>::PARTS * W_BYTES; }

template <typename T>
__host__ __device__ constexpr int smem_bytes() {  // + 1 KB to align the ring to the swizzle's 1024-byte atom
  return 1024 + Cfg<T>::STAGES * stage_bytes<T>() + 2 * Cfg<T>::STAGES * 8;
}

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Spins until the barrier's phase differs from `parity`. A wait of more
// than 2^32 cycles (~2 s; no stage of a launch takes a millisecond) is a
// pipeline fault: it traps, an error the caller sees, instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  const long long start = clock64();
  while (!done) {
    if (clock64() - start > (1ll << 32)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major operand in a 128-byte-swizzled tile whose
// rows are 128 bytes: 8-row groups 1024 bytes apart (SBO), layout B128. A
// k-step inside the row advances the start address.
__device__ __forceinline__ uint64_t desc_b128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

#define D8(i)                                                                            \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])
#define D64 D8(0), D8(8), D8(16), D8(24), D8(32), D8(40), D8(48), D8(56)
#define R64                                                                                 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "  \
  "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "   \
  "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "   \
  "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64] += A (64 x 16, shared memory) * B (16 x 128, shared memory), bf16 in
__device__ __forceinline__ void wgmma_bf16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " R64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : D64
      : "l"(da), "l"(db), "r"(1));
}

// d[64] += A (64 x 8, registers, tf32) * B (8 x 128, shared memory, tf32)
__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef D8
#undef D64
#undef R64

__device__ __forceinline__ uint32_t to_tf32(float v) {  // round to nearest, ties away
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float epilogue(float acc, float s, float t, float r, float b, float wr,
                                          float x) {
  float v = acc * s + t;
  v = v >= 0.f ? v : SLOPE * v;
  return v * r + b + x * wr;
}

struct Tile {
  int64_t b, t0;
  int k_lo, n_taps;
};

// Tile i in time order, and its live taps: k is dead when its rows
// [t0 + (k-7)d, t0 + (k-7)d + BM) lie wholly outside [0, T).
template <int BM>
__device__ __forceinline__ Tile tile_at(int64_t i, int64_t tiles_per_b, int64_t t_len, int d) {
  Tile tl;
  tl.b = i / tiles_per_b;
  tl.t0 = (i % tiles_per_b) * BM;
  int k_lo = 0, k_hi = TAPS - 1;
  while (tl.t0 + static_cast<int64_t>(k_lo - HALF) * d + BM <= 0) ++k_lo;
  while (tl.t0 + static_cast<int64_t>(k_hi - HALF) * d >= t_len) --k_hi;
  tl.k_lo = k_lo;
  tl.n_taps = k_hi - k_lo + 1;
  return tl;
}

// ------------------------------------------------------------ the kernel

template <typename T>
__global__ void __launch_bounds__(THREADS, 1)
tcn_block_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                 const T* __restrict__ x, const float* __restrict__ s,
                 const float* __restrict__ tt, const float* __restrict__ r,
                 const float* __restrict__ fb, const float* __restrict__ wr, T* __restrict__ y,
                 int64_t t_len, int64_t tiles_per_b, int64_t n_tiles, int d) {
  constexpr int STAGES = Cfg<T>::STAGES;
  constexpr int CH = Cfg<T>::CH;
  constexpr int CHUNKS = C / CH;
  constexpr int SB = stage_bytes<T>();
  constexpr int BM = Cfg<T>::BM;
  constexpr int X_BYTES = x_bytes<T>();
  constexpr int HALVES = BM / (CONSUMERS * 64);  // 64-row wgmma tiles a warpgroup owns

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  uint8_t* smem = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t ring = smem_u32(smem);  // stage j: x box, then w box(es)
  const uint32_t full = ring + STAGES * SB;
  const uint32_t empty = full + STAGES * 8;

  if (threadIdx.x == 0) {
    for (int j = 0; j < STAGES; ++j) {
      mbar_init(full + 8 * j, 1);
      mbar_init(empty + 8 * j, RELEASERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == CONSUMERS) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS) : "memory");
    if (threadIdx.x % 128 == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int64_t i = blockIdx.x; i < n_tiles; i += gridDim.x) {
        const Tile tl = tile_at<BM>(i, tiles_per_b, t_len, d);
        for (int k = tl.k_lo; k < tl.k_lo + tl.n_taps; ++k) {
          const int row = static_cast<int>(tl.t0 + static_cast<int64_t>(k - HALF) * d);
          for (int c = 0; c < CHUNKS; ++c) {
            mbar_wait(empty + 8 * stage, phase ^ 1);
            const uint32_t bar = full + 8 * stage;
            const uint32_t dst = ring + stage * SB;
            mbar_expect_tx(bar, SB);
            tma_load_3d(dst, &xmap, bar, c * CH, row, static_cast<int>(tl.b));
#pragma unroll
            for (int p = 0; p < Cfg<T>::PARTS; ++p)
              tma_load_2d(dst + X_BYTES + p * W_BYTES, &wmap, bar, c * CH, (p * TAPS + k) * C);
            if (++stage == STAGES) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS) : "memory");
    const int warp = (threadIdx.x / 32) % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4;
    const int tig = lane % 4;
    const uint32_t rows = wg * HALVES * 64 * ROW_BYTES;  // this warpgroup's rows in a stage
    int stage = 0;
    uint32_t phase = 0;
    float acc[HALVES][64];  // [64-row half][wgmma fragment]

    for (int64_t i = blockIdx.x; i < n_tiles; i += gridDim.x) {
      const Tile tl = tile_at<BM>(i, tiles_per_b, t_len, d);
#pragma unroll
      for (int h = 0; h < HALVES; ++h)
#pragma unroll
        for (int q = 0; q < 64; ++q) acc[h][q] = 0.f;

      const int iters = tl.n_taps * CHUNKS;
      if constexpr (std::is_same<T, __nv_bfloat16>::value) {
        int prev = 0;
        for (int it = 0; it < iters; ++it) {
          mbar_wait(full + 8 * stage, phase);
          const uint32_t xs = ring + stage * SB + rows;
          const uint32_t ws = ring + stage * SB + X_BYTES;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {  // k16 steps of 32 bytes
            const uint64_t db = desc_b128(ws + 32 * kk);
#pragma unroll
            for (int h = 0; h < HALVES; ++h)
              wgmma_bf16(acc[h], desc_b128(xs + h * 64 * ROW_BYTES + 32 * kk), db);
          }
          wgmma_commit();
          wgmma_wait<1>();  // the previous stage's products are done: free it
          if (it > 0) {
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + 8 * prev);
          }
          prev = stage;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        wgmma_wait<0>();
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + 8 * prev);
      } else {
        // 3xTF32. A fragment of m64n128k8 for warp w: rows 16w + g (+8),
        // columns tig (+4) of the k-step. In the swizzled stage, 16-byte
        // chunk j of row r sits at chunk j ^ (r % 8), and r % 8 == g.
        // The tensor cores' float32 accumulation does not round to nearest
        // (a bias of ~1.5e-5 of max|y| over 720 accumulating wgmmas, on the
        // H100): each stage's products go into a zeroed `part`, which is
        // added to `acc` with a rounded float32 add. acc, part and the
        // stage's A fragments fit the consumers' registers with 64 rows a
        // warpgroup (BM = 128), not with 128.
        for (int it = 0; it < iters; ++it) {
          mbar_wait(full + 8 * stage, phase);
          const uint32_t wb = ring + stage * SB + X_BYTES;
          const uint32_t wsm = wb + W_BYTES;
          const float* xrow0 =
              reinterpret_cast<const float*>(smem + stage * SB + rows) + (warp * 16 + g) * 32;
#pragma unroll
          for (int h = 0; h < HALVES; ++h) {
            const float* p = xrow0 + h * 64 * 32;
            uint32_t big[4][4], small[4][4];  // [k-step][fragment]
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const int lo = ((2 * kk) ^ g) * 4 + tig;
              const int hi = ((2 * kk + 1) ^ g) * 4 + tig;
              const float v[4] = {p[lo], p[8 * 32 + lo], p[hi], p[8 * 32 + hi]};
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                big[kk][q] = to_tf32(v[q]);
                small[kk][q] = to_tf32(v[q] - __uint_as_float(big[kk][q]));
              }
            }
            float part[64];
#pragma unroll
            for (int q = 0; q < 64; ++q) part[q] = 0.f;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              const uint64_t db = desc_b128(wb + 32 * kk);
              wgmma_tf32(part, small[kk], db);
              wgmma_tf32(part, big[kk], desc_b128(wsm + 32 * kk));
              wgmma_tf32(part, big[kk], db);
            }
            wgmma_commit();
            wgmma_wait<0>();
#pragma unroll
            for (int q = 0; q < 64; ++q) acc[h][q] += part[q];
          }
          __syncwarp();
          if (lane == 0) mbar_arrive(empty + 8 * stage);
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
      }

      // epilogue: fragment q of 8-column block j is row 16*warp + g + 8*((q>>1)&1),
      // column 8j + 2*tig + (q&1), in each 64-row half
      const int64_t row0 = tl.t0 + wg * HALVES * 64 + warp * 16 + g;
      const T* xb = x + tl.b * t_len * C;
      T* yb = y + tl.b * t_len * C;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int o = 8 * j + 2 * tig;
        const float2 sv = load2(s + o), tv = load2(tt + o), wv = load2(wr + o);
        const float2 rv = load2(r + tl.b * C + o), bv = load2(fb + tl.b * C + o);
#pragma unroll
        for (int h = 0; h < HALVES; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int64_t row = row0 + 64 * h + 8 * e;
            if (row >= t_len) continue;
            const float2 xin = load2(xb + row * C + o);
            store2(yb + row * C + o,
                   epilogue(acc[h][4 * j + 2 * e], sv.x, tv.x, rv.x, bv.x, wv.x, xin.x),
                   epilogue(acc[h][4 * j + 2 * e + 1], sv.y, tv.y, rv.y, bv.y, wv.y, xin.y));
          }
      }
    }
  }
}

// ------------------------------------------------------------ host side

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// 128-byte-swizzled tensor map over a row-major array with 128 elements a
// row: dims[0] = 128 (channels), box = one 128-byte chunk x box_rows x 1.
template <typename T>
bool encode(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims, int box_rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  cuuint64_t strides[2] = {C * sizeof(T), dims[1] * C * sizeof(T)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(Cfg<T>::CH), static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, Cfg<T>::DT, rank, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch(const void* x, const void* w, const void* s, const void* tt, const void* r,
           const void* fb, const void* wr, void* y, long long batch, long long t_len, int d,
           void* stream) {
  // TMA coordinates are 32-bit: every row a tap reads must fit in int32
  if (batch <= 0 || t_len <= 0 || d <= 0 || batch > 0x7fffffffLL ||
      t_len + Cfg<T>::BM + static_cast<long long>(HALF) * d > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, wmap;
  const cuuint64_t xdims[3] = {C, static_cast<cuuint64_t>(t_len), static_cast<cuuint64_t>(batch)};
  const cuuint64_t wdims[2] = {C, static_cast<cuuint64_t>(Cfg<T>::PARTS * TAPS * C)};
  if (!encode<T>(&xmap, x, 3, xdims, Cfg<T>::BM) || !encode<T>(&wmap, w, 2, wdims, C))
    return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(tcn_block_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes<T>());
  if (e != cudaSuccess) return static_cast<int>(e);
  const long long tiles_per_b = (t_len + Cfg<T>::BM - 1) / Cfg<T>::BM;
  const long long n_tiles = batch * tiles_per_b;
  const unsigned grid = static_cast<unsigned>(n_tiles < sms ? n_tiles : sms);
  tcn_block_kernel<T><<<grid, THREADS, smem_bytes<T>(), static_cast<cudaStream_t>(stream)>>>(
      xmap, wmap, static_cast<const T*>(x), static_cast<const float*>(s),
      static_cast<const float*>(tt), static_cast<const float*>(r), static_cast<const float*>(fb),
      static_cast<const float*>(wr), static_cast<T*>(y), t_len, tiles_per_b, n_tiles, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C interface (bound with ctypes). Pointers are device pointers of
// contiguous, 16-byte-aligned tensors: x, y [B, T, 128] in the kernel's
// type; w K-major as w_t[k][out][in] (bf16: [15, 128, 128]; float32:
// [2, 15, 128, 128], w_big then w_small, both tf32-rounded); s, tt, wr [128]
// and r, fb [B, 128] in float32. Launches on `stream`, does not
// synchronise, returns a CUDA error code (0 on success).
extern "C" int tcn_block_f32(const void* x, const void* w, const void* s, const void* tt,
                             const void* r, const void* fb, const void* wr, void* y,
                             long long batch, long long t_len, int d, void* stream) {
  return launch<float>(x, w, s, tt, r, fb, wr, y, batch, t_len, d, stream);
}

extern "C" int tcn_block_bf16(const void* x, const void* w, const void* s, const void* tt,
                              const void* r, const void* fb, const void* wr, void* y,
                              long long batch, long long t_len, int d, void* stream) {
  return launch<__nv_bfloat16>(x, w, s, tt, r, fb, wr, y, batch, t_len, d, stream);
}

// The tiling of the float32 (fp32 != 0) or bf16 kernel: time rows a tile
// and w boxes a stage, for figures derived from it (L2 traffic).
extern "C" void tcn_block_tiling(int fp32, int* rows, int* w_parts) {
  *rows = fp32 ? Cfg<float>::BM : Cfg<__nv_bfloat16>::BM;
  *w_parts = fp32 ? Cfg<float>::PARTS : Cfg<__nv_bfloat16>::PARTS;
}
