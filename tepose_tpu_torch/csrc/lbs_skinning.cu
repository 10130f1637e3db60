// Linear-blend skinning for the SMPL forward, fp32, for Hopper (sm_90a).
//
// Replaces tepose_tpu/ops/lbs_pallas.py::lbs_skinning_pallas and its body
// _skin_kernel (the Pallas TPU kernel, pl.pallas_call at lbs_pallas.py:76).
// It computes, for every sample b and vertex v,
//
//   T         = sum_j W[v, j] * A[b, j]        (top 3 rows of a 4x4)
//   out[b, v] = T[:, :3] @ v_posed[b, v] + T[:, 3]
//
// and, like the TPU kernel, never writes the (B, V, 4, 4) per-vertex
// transform to device memory.
//
// What bounds it (V = 6890, J = 24; 594 flops per sample and vertex: the
// blend's 288 FMAs and the apply's 9 FMAs; bytes = v_posed + out + W^T + A,
// each once; 67 TFLOP/s fp32 without tensor cores, 3.35 TB/s):
//   * B = 32:  0.131 GFLOP = 1.95 us against 6.0 MB = 1.79 us;
//   * B = 256: 1.048 GFLOP = 15.6 us against 43.4 MB = 12.95 us.
// Both sit on the FMA rate with the memory time close behind, so the blend
// must issue FMAs with little else in the way while the data streams.
//
// Design. A thread owns VPT vertices (lane + 32 q of its warp's 32 * VPT
// consecutive vertices) and keeps their J weights in registers for every
// sample of its block's run of samples, so W^T leaves L2 once per block,
// not once per sample. Per sample, the block stages the sample's transforms
// (top three rows, 12 floats a joint) in shared memory with cp.async,
// double-buffered behind one block barrier; per joint a thread then reads
// the joint's 12 values with three broadcast 16-byte loads and does 12 * VPT
// FMAs into 12 * VPT accumulators. J is a template parameter, so the joint
// loop unrolls and the weights stay in registers.
//   * VPT = 4 (SMPL's 24 joints, larger batches): 3 shared loads per 48
//     FMAs; 96 weights + 48 accumulators per thread, about 200 registers,
//     so a 64-thread block and four blocks an SM.
//   * VPT = 1 (small batches, where latency and not the FMA rate sets the
//     time, and any joint count 1..32 through the 32-joint instantiation
//     with the missing joints' weights and transforms zero).
// v_posed and the output move with 4-byte accesses: at a warp's lane
// stride of 12 bytes, each access instruction covers 384 contiguous bytes.
// The v_posed loads are issued before the blend that hides them.
//
// Alignment: with V = 6890 one sample's rows are 82,680 bytes, so an odd
// sample starts 8 bytes off a 16-byte boundary; a row of W^T (27,560 bytes)
// likewise, and a view at a storage offset is only 4-byte aligned. Only the
// transforms are copied in 16-byte pieces, and only where the sample's
// transforms start on a 16-byte boundary (4-byte copies otherwise);
// everything else is read and written 4 bytes at a time, so any 4-byte
// aligned tensor works.
//
// Launch shape: grid (tiles, groups) of blocks of `threads`; a tile is
// threads * VPT vertices (the ragged last one masked), and the groups split
// B into runs of B / groups samples, the first B % groups runs one longer.
// The wrapper (ops/lbs_skinning.py::_launch_config) picks VPT from B and J
// and as many groups as fill one wave of four blocks an SM.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxJoints = 32;
constexpr int kBlocksPerSM = 4;

// Most threads a block of each variant takes (as in its __launch_bounds__):
// four blocks of them fit an SM's 64K registers at the register count that
// __launch_bounds__ then allows.
constexpr int max_threads(int vpt) { return vpt == 1 ? 128 : 64; }

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(smem)), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// One sample's transforms into shared memory: rows 0..2 of each joint's
// row-major 4x4, its first 12 floats; joints J..JP-1 are left alone.
__device__ __forceinline__ void load_transforms(float* tf, const float* A_b,
                                                int J, int tid, int T) {
  if ((reinterpret_cast<uintptr_t>(A_b) & 15) == 0) {
    for (int i = tid; i < J * 3; i += T) {
      const int j = i / 3, k = i - 3 * j;
      cp_async16(tf + 12 * j + 4 * k, A_b + 16 * j + 4 * k);
    }
  } else {
    for (int i = tid; i < J * 12; i += T) {
      const int j = i / 12, k = i - 12 * j;
      cp_async4(tf + i, A_b + 16 * j + k);
    }
  }
}

template <int JP, int VPT>
__global__ void __launch_bounds__(VPT == 1 ? 128 : 64, kBlocksPerSM)
lbs_skin_kernel(const float* __restrict__ wT, const float* __restrict__ A,
                const float* __restrict__ v, float* __restrict__ out, int B,
                int V, int J, int groups) {
  __shared__ __align__(16) float s_tf[2 * JP * 12];  // two samples' joints
  const int T = blockDim.x, tid = threadIdx.x;
  // this thread's vertex q is first + 32 q
  const int first = blockIdx.x * T * VPT + (tid >> 5) * 32 * VPT + (tid & 31);
  const int g = blockIdx.y, per = B / groups, extra = B % groups;
  const int b_begin = g * per + min(g, extra);
  const int b_end = b_begin + per + (g < extra ? 1 : 0);

  float w[VPT][JP];
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const int vtx = first + 32 * q;
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      w[q][j] = (j < J && vtx < V)
                    ? __ldg(&wT[static_cast<size_t>(j) * V + vtx])
                    : 0.0f;
    }
  }
  // joints J..JP-1: zero transforms, never overwritten
  for (int i = J * 12 + tid; i < JP * 12; i += T) {
    s_tf[i] = 0.0f;
    s_tf[JP * 12 + i] = 0.0f;
  }
  load_transforms(s_tf, A + static_cast<size_t>(b_begin) * J * 16, J, tid, T);
  cp_async_commit();

  for (int b = b_begin; b < b_end; ++b) {
    const int buf = (b - b_begin) & 1;
    float p[VPT][3];  // v_posed, used after the blend
#pragma unroll
    for (int q = 0; q < VPT; ++q) {
      const int vtx = first + 32 * q;
      const float* vp = v + (static_cast<size_t>(b) * V + vtx) * 3;
#pragma unroll
      for (int k = 0; k < 3; ++k) p[q][k] = vtx < V ? __ldg(vp + k) : 0.0f;
    }
    cp_async_wait_all();
    __syncthreads();  // buf is in; every thread is done with buf ^ 1
    if (b + 1 < b_end) {
      load_transforms(s_tf + (buf ^ 1) * JP * 12,
                      A + static_cast<size_t>(b + 1) * J * 16, J, tid, T);
    }
    cp_async_commit();

    // acc[q] = top three rows of sum_j W[vertex q, j] * A[b, j]
    const float4* t4 = reinterpret_cast<const float4*>(s_tf + buf * JP * 12);
    float acc[VPT][12];
#pragma unroll
    for (int q = 0; q < VPT; ++q) {
#pragma unroll
      for (int r = 0; r < 12; ++r) acc[q][r] = 0.0f;
    }
#pragma unroll
    for (int j = 0; j < JP; ++j) {
      const float4 r0 = t4[3 * j], r1 = t4[3 * j + 1], r2 = t4[3 * j + 2];
      const float t[12] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y,
                           r1.z, r1.w, r2.x, r2.y, r2.z, r2.w};
#pragma unroll
      for (int q = 0; q < VPT; ++q) {
#pragma unroll
        for (int r = 0; r < 12; ++r) acc[q][r] = fmaf(w[q][j], t[r], acc[q][r]);
      }
    }

#pragma unroll
    for (int q = 0; q < VPT; ++q) {
      const int vtx = first + 32 * q;
      if (vtx < V) {
        float* o = out + (static_cast<size_t>(b) * V + vtx) * 3;
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          const float* a = acc[q] + 4 * r;
          o[r] = fmaf(a[0], p[q][0],
                      fmaf(a[1], p[q][1], fmaf(a[2], p[q][2], a[3])));
        }
      }
    }
  }
}

// The instantiation for J joints and VPT vertices per thread: four
// vertices for SMPL's 24 joints only, one for 24 or (zero-padded) 32.
const void* kernel_for(int J, int vpt) {
  if (vpt == 4) {
    return J == 24 ? reinterpret_cast<const void*>(&lbs_skin_kernel<24, 4>)
                   : nullptr;
  }
  return J == 24 ? reinterpret_cast<const void*>(&lbs_skin_kernel<24, 1>)
                 : reinterpret_cast<const void*>(&lbs_skin_kernel<kMaxJoints, 1>);
}

}  // namespace

extern "C" {

// wT (J, V), A (B, J, 4, 4), v (B, V, 3), out (B, V, 3): contiguous fp32 on
// one device, 4-byte aligned. The launch shape comes from the caller
// (ops/lbs_skinning.py::_launch_config): `verts_per_thread` (1, or 4 for
// J = 24), `threads` per block (a multiple of 32, at most 128 for one
// vertex per thread and 64 for four) and `groups` sample groups (1..B).
// Launches on `stream` and returns cudaGetLastError() after the launch (0
// on success); cudaErrorInvalidValue for a shape it does not take. It does
// not synchronise.
int tepose_lbs_skin_f32(const float* wT, const float* A, const float* v,
                        float* out, int B, int V, int J, int threads,
                        int verts_per_thread, int groups, void* stream) {
  if (B < 1 || V < 1 || J < 1 || J > kMaxJoints ||
      (verts_per_thread != 1 && verts_per_thread != 4) || threads < 32 ||
      threads % 32 != 0 || threads > max_threads(verts_per_thread) ||
      groups < 1 || groups > B || groups > 65535 ||
      kernel_for(J, verts_per_thread) == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // This library carries its own CUDA runtime, whose current device is not
  // the caller's: make it the device that holds the output.
  cudaPointerAttributes attr;
  cudaError_t err = cudaPointerGetAttributes(&attr, out);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaSetDevice(attr.device);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int tile = threads * verts_per_thread;
  const dim3 grid((V + tile - 1) / tile, groups);
  const auto s = static_cast<cudaStream_t>(stream);
  if (verts_per_thread == 4) {
    lbs_skin_kernel<24, 4><<<grid, threads, 0, s>>>(wT, A, v, out, B, V, J,
                                                     groups);
  } else if (J == 24) {
    lbs_skin_kernel<24, 1><<<grid, threads, 0, s>>>(wT, A, v, out, B, V, J,
                                                     groups);
  } else {
    lbs_skin_kernel<kMaxJoints, 1><<<grid, threads, 0, s>>>(wT, A, v, out, B,
                                                             V, J, groups);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks of `threads` that one SM holds at once for the instantiation the
// launch of J joints and `verts_per_thread` uses (the wrapper's launch rule
// assumes four); negative on error.
int tepose_lbs_blocks_per_sm(int J, int verts_per_thread, int threads) {
  const void* fn = kernel_for(J, verts_per_thread);
  if (fn == nullptr) return -static_cast<int>(cudaErrorInvalidValue);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, fn, threads, 0);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

const char* tepose_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
