// ViT-H's linear layers, Y = epi(X W^T + b), float32 in and out, on the
// H100's tensor cores in 3xTF32 (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no ViT. It serves HMR 2.0's
// ViTPose-H backbone (models/vit.py), whose four linear layers a block
// (attn.qkv, attn.proj, mlp.fc1, mlp.fc2) are most of the model's work. In
// strict float32 cuBLAS runs them as a SIMT SGEMM, whose ceiling is the
// card's 67 TFLOP/s FP32 rate; the tensor cores reach float32 accuracy only
// through a split product, which this kernel computes.
//
// What bounds it: operations. At the main path's M = 24,576 rows (128 crops
// of 192 tokens) a product does 2 M N K flops on 4 (M K + N K + M N) bytes:
// 462 flops a byte for qkv (N 3,840, K 1,280), 491 for fc2 (N 1,280,
// K 5,120). One crop (M = 192) still does 80 a byte on qkv. The ridge of
// 3xTF32 on an H100 is 165 TFLOP/s of the product's own flops (a third of
// the 495 TFLOP/s TF32 rate) over 3.35 TB/s, 49 a byte: every shape sits
// above it, so the design keeps the tensor cores fed.
//
// The split (3xTF32). A tensor-core TF32 product keeps 10 of float32's 23
// mantissa bits. Each operand value a is split into a_big = tf32_rn(a) and
// a_small = tf32_rn(a - a_big), both rounded to nearest with
// cvt.rna.tf32.f32 (wgmma itself truncates the low 13 bits, which would
// leave a_small twice as large), and
//   a b ~ a_big b_big + a_big b_small + a_small b_big,
// each product exact in float32. The dropped a_small b_small and the
// rounding of the small parts are near 2^-22 of |a b|.
//   * X is split inside the kernel: each consumer thread reads its A
//     fragment of the tile from shared memory, splits it in registers and
//     issues wgmma with A from registers.
//   * W is split by a small pass at each launch (`split_tf32_kernel`) into
//     scratch the wrapper allocates, W_big and W_small, which wgmma reads
//     from shared memory. Nothing is cached across calls.
//   * The sum over K. The tensor cores add into their float32 accumulator
//     with truncation, so a sum carried through every wgmma of K = 1,280
//     drifts by ~1e-5 of its size (5x cuBLAS's SGEMM's error from float64,
//     measured on an H100). Each stage
//     of 32 columns of K therefore sums its 12 products in a fresh
//     accumulator, which the thread then adds to the running sum in
//     float32, rounded to nearest: a blocked sum, closer to float64 than
//     the SGEMM's sequential one.
//
// Design. A persistent grid, one block an SM, walks the output tiles of 128
// rows x BN columns (BN 128, or 64 where 128-wide tiles would leave SMs idle
// in the last wave; the wrapper picks from the shape), in groups of 8 rows
// of tiles, a column at a time, for L2's sake (4-5 % on fc1, whose W_big and
// W_small are 52 MB, more than L2 holds). Warpgroup 0 is the producer: one
// thread keeps TMA loads of X, W_big and W_small in a ring of shared-memory
// stages of 32 columns of K (one 128-byte swizzled row a tile row), each
// stage's arrival on a "full" mbarrier. Warpgroups 1 and 2 each own 64 rows
// of the tile: per stage and per k8 step, three wgmma.m64nBNk8 tf32 (a_small
// W_big, a_big W_small, a_big W_big) into the stage's accumulator; while
// they run, the thread reads and splits the next stage's fragment into a
// second register set; once they are done each warp releases the stage on
// its "empty" mbarrier and adds the stage's sum into the running one. Only
// that wait, release and add lie between one stage's products and the next,
// and the other warpgroup's products fill them, so the tensor cores stay
// busy (reading the fragment ahead gained 5-10 % on an H100). The epilogue
// adds the bias and then nothing, the exact erf GELU (fc1), or the residual
// (proj and fc2, the block's `x + ...`), and stores straight from the
// registers, masking rows past M (TMA fills them with zeros on the way in).
// The producer runs ahead into the next tile during the epilogue.
//
// Shapes it takes: K a multiple of 32, N a multiple of BN, 16-byte aligned
// contiguous row-major tensors (X (M, K), W (N, K) as nn.Linear keeps it,
// bias (N), residual and Y (M, N)). The C entry refuses anything else.

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

namespace {

constexpr int kBM = 128;            // rows of a tile: two consumer warpgroups
constexpr int kBK = 32;             // columns of K a stage: one 128-byte row
constexpr int kRowBytes = kBK * 4;
constexpr int kThreads = 384;       // producer warpgroup + two consumers
constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use
constexpr int kMaxStages = 8;
constexpr uint32_t kMaxSpins = 1u << 24;  // far past any real wait
constexpr int kGroupM = 8;  // rows of tiles the grid walks a column at a time

enum Epilogue { kBias = 0, kGelu = 1, kResidual = 2 };

// Shared memory of one block: `kStages` stages of [X | W_big | W_small],
// each tile kBK floats wide, then the mbarriers.
template <int BN>
struct Tile {
  static constexpr int kABytes = kBM * kRowBytes;
  static constexpr int kBBytes = BN * kRowBytes;
  static constexpr int kStageBytes = kABytes + 2 * kBBytes;
  static constexpr int kFit = (kSmemLimit - 1024 - 256) / kStageBytes;
  static constexpr int kStages = kFit > kMaxStages ? kMaxStages : kFit;
  static constexpr int kSmemBytes = 1024 + kStages * kStageBytes + 256;
  static_assert(kStages >= 2, "at least two stages");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Waits for the phase of parity `parity` to complete. A wait that outlasts
// any real one (a lost arrival) traps, so a fault fails the launch and
// does not hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (spins == kMaxSpins) __trap();
  }
}

// One TMA load of a 2-D box at (c0 along K, c1 along rows) into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// a = big + small, both TF32 values rounded to nearest.
__device__ __forceinline__ void split_tf32(float a, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(a);
  small = tf32_rna(a - __uint_as_float(big));
}

// wgmma's shared-memory descriptor of a K-major tile of 128-byte swizzled
// rows: start address, 1,024 bytes from one 8-row group to the next, the
// 128-byte swizzle (the leading offset is unused for such tiles).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>((8 * kRowBytes) >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of `acc` across the
// asynchronous products.
template <int N>
__device__ __forceinline__ void fence_operands(float (&acc)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

// D (64 x 64) = A (64 x 8, registers) * B (64 x 8, shared memory)
// + (scale_d ? D : 0), tf32 in, float32 accumulator.
__device__ __forceinline__ void wgmma_m64n64k8(float (&d)[32],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D (64 x 128) = A (64 x 8, registers) * B (128 x 8, shared memory)
// + (scale_d ? D : 0), tf32 in, float32 accumulator.
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      " %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      " %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// A consumer thread's A fragment of one stage, split: for each of the
// stage's four k8 steps j, rows r and r + 8 at columns 8 j + t and
// 8 j + t + 4, as wgmma takes A from registers.
struct Frag {
  uint32_t big[kBK / 8][4], small[kBK / 8][4];
};

// Reads and splits the fragment from the stage's X tile: row byte offsets
// row0, row1 (rows r, r + 8, which share r % 8); column c sits in 16-byte
// chunk c / 4, which the 128-byte swizzle moves to (c / 4) ^ (r % 8).
__device__ __forceinline__ void load_split(Frag& f, const uint8_t* a_tile,
                                           uint32_t row0, uint32_t row1,
                                           uint32_t key, int t) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    const uint32_t c0 = ((2 * j) ^ key) << 4, c1 = ((2 * j + 1) ^ key) << 4;
    const float* p = reinterpret_cast<const float*>(a_tile + 4 * t);
    split_tf32(p[(row0 + c0) / 4], f.big[j][0], f.small[j][0]);
    split_tf32(p[(row1 + c0) / 4], f.big[j][1], f.small[j][1]);
    split_tf32(p[(row0 + c1) / 4], f.big[j][2], f.small[j][2]);
    split_tf32(p[(row1 + c1) / 4], f.big[j][3], f.small[j][3]);
  }
}

// Keeps `f` in its registers up to here: the fragment of products in
// flight must not share registers with the next one, read meanwhile.
__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      asm volatile("" : "+r"(f.big[j][i]), "+r"(f.small[j][i])::"memory");
    }
  }
}

template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc_b, int scale_d) {
  if constexpr (BN == 128) {
    wgmma_m64n128k8(d, a, desc_b, scale_d);
  } else {
    wgmma_m64n64k8(d, a, desc_b, scale_d);
  }
}

// Issues one stage's 12 products into `part` (W_big and W_small tiles at
// shared addresses b_big, b_small): per k8 step j, a_small W_big,
// a_big W_small, a_big W_big, the first of them starting `part` afresh.
// Step j starts 32 bytes further along the swizzled rows.
template <int BN>
__device__ __forceinline__ void issue_stage(float (&part)[BN / 2],
                                            const Frag& f, uint32_t b_big,
                                            uint32_t b_small) {
  const uint64_t desc_big = smem_desc(b_big);
  const uint64_t desc_small = smem_desc(b_small);
  fence_operands(part);
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kBK / 8; ++j) {
    wgmma_tf32<BN>(part, f.small[j], desc_big + 2 * j, j > 0);
    wgmma_tf32<BN>(part, f.big[j], desc_small + 2 * j, 1);
    wgmma_tf32<BN>(part, f.big[j], desc_big + 2 * j, 1);
  }
  wgmma_commit();
}

// The origin (m0, n0) of the persistent grid's tile number `tile`: tiles
// go down groups of kGroupM rows of tiles, a column at a time, so the
// tiles in flight at once share a few rows of X and columns of W in L2.
__device__ __forceinline__ void tile_origin(int tile, int m_tiles, int n_tiles,
                                            int bn, int& m0, int& n0) {
  const int per_group = kGroupM * n_tiles;
  const int g = tile / per_group, r = tile % per_group;
  const int rows = min(kGroupM, m_tiles - g * kGroupM);
  m0 = (g * kGroupM + r % rows) * kBM;
  n0 = r / rows * bn;
}

__device__ __forceinline__ float gelu_erf(float v) {
  return v * 0.5f * (1.0f + erff(v * 0.70710678118654752f));
}

// Two neighbouring outputs of row `row`, columns col and col + 1.
__device__ __forceinline__ void store_pair(float* __restrict__ y,
                                           const float* __restrict__ residual,
                                           int epilogue, int row, int col,
                                           int M, int N, float v0, float v1) {
  if (row >= M) return;
  const size_t at = static_cast<size_t>(row) * N + col;
  if (epilogue == kGelu) {
    v0 = gelu_erf(v0);
    v1 = gelu_erf(v1);
  } else if (epilogue == kResidual) {
    const float2 r = *reinterpret_cast<const float2*>(residual + at);
    v0 = r.x + v0;
    v1 = r.y + v1;
  }
  *reinterpret_cast<float2*>(y + at) = make_float2(v0, v1);
}

template <int BN>
__global__ void __launch_bounds__(kThreads, 1)
    vit_gemm_kernel(const __grid_constant__ CUtensorMap x_map,
                    const __grid_constant__ CUtensorMap wbig_map,
                    const __grid_constant__ CUtensorMap wsmall_map,
                    const float* __restrict__ bias,
                    const float* __restrict__ residual,
                    float* __restrict__ y, int M, int N, int K,
                    int epilogue) {
  using T = Tile<BN>;
  extern __shared__ uint8_t smem_raw[];
  // stages on a 1024-byte boundary, so the swizzle's address bits are the
  // tile's own
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* base_ptr = smem_raw + (base - raw);
  const uint32_t full_bar = base + T::kStages * T::kStageBytes;
  const uint32_t empty_bar = full_bar + 8 * T::kStages;

  const int n_tiles = N / BN;
  const int m_tiles = (M + kBM - 1) / kBM;
  const int tiles = m_tiles * n_tiles;
  const int k_steps = K / kBK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, 8);  // each consumer warp releases
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        int m0, n0;
        tile_origin(tile, m_tiles, n_tiles, BN, m0, n0);
        for (int k = 0; k < k_steps; ++k) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t st = base + stage * T::kStageBytes;
          const uint32_t full = full_bar + 8 * stage;
          mbar_expect_tx(full, T::kStageBytes);
          tma_load(st, &x_map, full, k * kBK, m0);
          tma_load(st + T::kABytes, &wbig_map, full, k * kBK, n0);
          tma_load(st + T::kABytes + T::kBBytes, &wsmall_map, full, k * kBK,
                   n0);
          if (++stage == T::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int warp = threadIdx.x / 32 % 4;
    const int lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    // this thread's two rows of the tile (the A fragment's and the
    // accumulator's): r and r + 8
    const int r = (wg - 1) * 64 + warp * 16 + g;
    const uint32_t row0 = r * kRowBytes, row1 = (r + 8) * kRowBytes;
    const uint32_t key = r % 8;
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) part[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    // One stage: its products (A fragment `cur`, read and split before)
    // issued; while they run, the next stage's fragment read and split
    // into `next`; then the products waited on, the stage released and its
    // sum added into `acc`.
    auto step = [&](int k, Frag& cur, Frag& next) {
      const uint32_t st = base + stage * T::kStageBytes;
      issue_stage<BN>(part, cur, st + T::kABytes, st + T::kABytes + T::kBBytes);
      const int done = stage;
      if (++stage == T::kStages) {
        stage = 0;
        phase ^= 1;
      }
      if (k + 1 < k_steps) {
        mbar_wait(full_bar + 8 * stage, phase);
        load_split(next, base_ptr + stage * T::kStageBytes, row0, row1, key,
                   t);
      }
      wgmma_wait_all();
      fence_operands(part);
      fence_frag(cur);
      if (lane == 0) mbar_arrive(empty_bar + 8 * done);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    };
    Frag f0, f1;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      int m0, n0;
      tile_origin(tile, m_tiles, n_tiles, BN, m0, n0);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;
      mbar_wait(full_bar + 8 * stage, phase);
      load_split(f0, base_ptr + stage * T::kStageBytes, row0, row1, key, t);
      // two stages a turn, so each fragment set keeps registers of its own
      for (int k = 0; k < k_steps; k += 2) {
        step(k, f0, f1);
        if (k + 1 < k_steps) step(k + 1, f1, f0);
      }
      // accumulator element 4 j + 2 h + e: row r + 8 h, column 8 j + 2 t + e
      const int row = m0 + r;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int col = n0 + 8 * j + 2 * t;
        float2 b = make_float2(0.0f, 0.0f);
        if (bias != nullptr) b = *reinterpret_cast<const float2*>(bias + col);
        store_pair(y, residual, epilogue, row, col, M, N, acc[4 * j] + b.x,
                   acc[4 * j + 1] + b.y);
        store_pair(y, residual, epilogue, row + 8, col, M, N,
                   acc[4 * j + 2] + b.x, acc[4 * j + 3] + b.y);
      }
    }
  }
}

// W (n4 float4s) -> W_big, W_small.
__global__ void split_tf32_kernel(const float4* __restrict__ w,
                                  float4* __restrict__ big,
                                  float4* __restrict__ small, size_t n4) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < n4; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const float4 v = w[i];
    uint32_t b[4], s[4];
    split_tf32(v.x, b[0], s[0]);
    split_tf32(v.y, b[1], s[1]);
    split_tf32(v.z, b[2], s[2]);
    split_tf32(v.w, b[3], s[3]);
    big[i] = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                         __uint_as_float(b[2]), __uint_as_float(b[3]));
    small[i] = make_float4(__uint_as_float(s[0]), __uint_as_float(s[1]),
                           __uint_as_float(s[2]), __uint_as_float(s[3]));
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the runtime's entry-point
// query, so the library links no libcuda of its own.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (rows, K) row-major float32 tensor read in boxes of `box_rows` x kBK,
// 128-byte swizzled; rows past the end read zero.
bool make_map(CUtensorMap* map, const float* ptr, int rows, int K,
              int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(K),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(K) * 4};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
                const_cast<float*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

int current_device() {
  int dev = 0;
  cudaGetDevice(&dev);
  return dev;
}

int num_sms(int dev) {
  int sms = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <int BN>
cudaError_t launch_gemm(const float* x, const float* w_big,
                        const float* w_small, const float* bias,
                        const float* residual, float* y, int M, int N, int K,
                        int epilogue, cudaStream_t stream) {
  using T = Tile<BN>;
  auto kernel = vit_gemm_kernel<BN>;
  const int dev = current_device();
  static uint64_t configured = 0;  // a bit a device
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!(configured >> dev & 1)) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
    if (err != cudaSuccess) return err;
    configured |= uint64_t{1} << dev;
  }
  CUtensorMap x_map, wbig_map, wsmall_map;
  if (!make_map(&x_map, x, M, K, kBM) ||
      !make_map(&wbig_map, w_big, N, K, BN) ||
      !make_map(&wsmall_map, w_small, N, K, BN)) {
    return cudaErrorInvalidValue;
  }
  const int tiles = (M + kBM - 1) / kBM * (N / BN);
  const int sms = num_sms(dev);
  const int grid = tiles < sms ? tiles : sms;
  kernel<<<grid, kThreads, T::kSmemBytes, stream>>>(
      x_map, wbig_map, wsmall_map, bias, residual, y, M, N, K, epilogue);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// Y (M, N) = epi(X (M, K) W (N, K)^T + bias (N)), every tensor contiguous
// row-major float32 on the current device, 16-byte aligned. `epilogue`: 0
// the bias alone, 1 then the exact GELU, 2 then + residual (M, N). `bias`
// may be null. `w_split` is scratch of 2 N K floats, W_big then W_small.
// `block_n` (128 or 64) is the tile's width. Launches the split and the
// product on `stream`; returns cudaGetLastError() after the launches (0 on
// success), cudaErrorInvalidValue for a shape or an argument it does not
// take. It does not synchronise.
int tepose_vit_linear_f32(const float* x, const float* w, float* w_split,
                          const float* bias, const float* residual, float* y,
                          int M, int N, int K, int epilogue, int block_n,
                          void* stream) {
  if (M < 1 || N < 1 || K < kBK || K % kBK != 0 ||
      (block_n != 128 && block_n != 64) || N % block_n != 0 ||
      epilogue < kBias || epilogue > kResidual ||
      (epilogue == kResidual) != (residual != nullptr)) {
    return cudaErrorInvalidValue;
  }
  for (const void* p : {static_cast<const void*>(x),
                        static_cast<const void*>(w),
                        static_cast<const void*>(w_split),
                        static_cast<const void*>(y)}) {
    if (p == nullptr || !aligned16(p)) return cudaErrorInvalidValue;
  }
  if ((bias != nullptr && !aligned16(bias)) ||
      (residual != nullptr && !aligned16(residual))) {
    return cudaErrorInvalidValue;
  }
  auto s = static_cast<cudaStream_t>(stream);
  const size_t n4 = static_cast<size_t>(N) * K / 4;
  float* w_big = w_split;
  float* w_small = w_split + static_cast<size_t>(N) * K;
  const size_t want = (n4 + 255) / 256;
  const size_t most = 8 * static_cast<size_t>(num_sms(current_device()));
  split_tf32_kernel<<<static_cast<int>(want < most ? want : most), 256, 0,
                      s>>>(reinterpret_cast<const float4*>(w),
                           reinterpret_cast<float4*>(w_big),
                           reinterpret_cast<float4*>(w_small), n4);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return block_n == 128 ? launch_gemm<128>(x, w_big, w_small, bias, residual,
                                           y, M, N, K, epilogue, s)
                        : launch_gemm<64>(x, w_big, w_small, bias, residual,
                                          y, M, N, K, epilogue, s);
}

const char* tepose_vit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
