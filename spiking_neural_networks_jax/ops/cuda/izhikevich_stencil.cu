// Temporal-blocked electrical Izhikevich lattice step for NVIDIA Hopper.
//
// One launch advances the lattice `n_steps` (K) steps.  Each block owns a
// core tile of the grid and loads it with an apron of K * 2 cells on every
// side (2 = the radius-2 stencil's reach).  The block keeps the voltage
// plane and the 12 stencil weight planes of that 64x64 extended tile in
// shared memory and the other state in registers, runs K steps with a block
// barrier between them, and writes back only the core: after k steps the
// cells within 2 k of the tile's edge hold wrong values, so an apron of
// 2 K keeps the core exact.  Weight planes are thus read from device memory
// once per launch instead of once per step.
//
// Arithmetic follows `core.lattice.lattice_step` on a StencilGraph with
// spatially uniform Izhikevich parameters (see
// `ops/stencil_kernel.izhikevich_multistep_reference`, the plain JAX form of
// the same algorithm):
//   acc   = sum_o w_o * (v[nbr_o] - v)         (w_o = 0 for off-grid nbr_o)
//   i_syn = gap * acc / max(in_deg, 1)
//   dv    = (0.04 v^2 + 5 v + 140 - w + i_syn) * (dt / c_m)
//   dw    = (a (b v - w)) * (dt / tau_m)
//   spike = v + dv >= v_th -> v = c, w += d, last_firing_time = clock
//
// The stencil is fixed: gap junctions within radius 2, the flagship's, so
// every shared-memory address is a constant offset from the cell's own.
//
// Built for sm_90a by `ops/stencil_kernel.build()` and called through the
// XLA foreign function interface as "snn_izhikevich_stencil".

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kThreads = 1024;
constexpr int kCellsPerThread = 4;
constexpr int kTile = 64;                   // extended tile, kTile x kTile
constexpr int kCells = kTile * kTile;       // = kThreads * kCellsPerThread
constexpr int kPad = 2;                     // the stencil's reach
constexpr int kVw = kTile + 2 * kPad;       // words in a voltage row
constexpr int kVCells = kVw * kVw;          // voltage plane with its margin
constexpr int kMaxSteps = 4;                // K; apron 2 K of a 64 tile

// The radius-2 stencil in `ops/graph.radius_offsets(2.0)` order:
// (-2,0) (-1,-1) (-1,0) (-1,1) (0,-2) (0,-1) (0,1) (0,2) (1,-1) (1,0)
// (1,1) (2,0).  Functions, so that unrolled loops fold them to constants.
constexpr int kNOff = 12;
__host__ __device__ constexpr int Dr(int o) {
  return o == 0 ? -2 : o < 4 ? -1 : o < 8 ? 0 : o < 11 ? 1 : 2;
}
__host__ __device__ constexpr int Dc(int o) {
  return o == 0 ? 0 : o < 4 ? o - 2 : o < 6 ? o - 6 : o < 8 ? o - 5
       : o < 11 ? o - 9 : 0;
}

// weight planes and the voltage plane with its zero margin: 215,104 bytes
constexpr size_t kSharedBytes = 4 * (kNOff * kCells + kVCells);

__global__ void __launch_bounds__(kThreads, 1)
IzhikevichStencilKernel(const float* __restrict__ v_in,
                        const float* __restrict__ w_in,
                        const int32_t* __restrict__ lft_in,
                        const float* __restrict__ wst,
                        const float* __restrict__ in_deg,
                        const float* __restrict__ params,
                        const int32_t* __restrict__ clock,
                        float* __restrict__ v_out, float* __restrict__ w_out,
                        int32_t* __restrict__ lft_out,
                        bool* __restrict__ spk_out, int rows, int cols,
                        int n_steps) {
  const int halo = n_steps * kPad;
  const int core = kTile - 2 * halo;
  const int r0 = blockIdx.y * core - halo;  // grid row of tile row 0
  const int c0 = blockIdx.x * core - halo;
  const size_t plane = static_cast<size_t>(rows) * cols;

  extern __shared__ float smem[];
  float* ws = smem;                 // (kNOff, kTile, kTile) masked weights
  float* vs = ws + kNOff * kCells;  // (kVw, kVw) voltage

  const int tid = threadIdx.x;
  for (int i = tid; i < kVCells; i += kThreads) vs[i] = 0.0f;

  const float a = params[0], b = params[1], c = params[2], d = params[3];
  const float v_th = params[4], gap = params[5];
  const float dt_tau = params[8] / params[6];
  const float dt_cm = params[8] / params[7];
  const int clock0 = clock[0];
  __syncthreads();

  float w_reg[kCellsPerThread], cnt[kCellsPerThread];
  int32_t lft[kCellsPerThread];
  int vidx[kCellsPerThread];
  bool live[kCellsPerThread], spk[kCellsPerThread];
#pragma unroll
  for (int j = 0; j < kCellsPerThread; ++j) {
    const int i = tid + j * kThreads;
    const int li = i / kTile, lj = i % kTile;
    const int gr = r0 + li, gc = c0 + lj;
    vidx[j] = (li + kPad) * kVw + lj + kPad;
    spk[j] = false;
    live[j] = gr >= 0 && gr < rows && gc >= 0 && gc < cols;
    if (!live[j]) continue;
    const size_t g = static_cast<size_t>(gr) * cols + gc;
    vs[vidx[j]] = v_in[g];
    w_reg[j] = w_in[g];
    lft[j] = lft_in[g];
    cnt[j] = fmaxf(in_deg[g], 1.0f);
    for (int o = 0; o < kNOff; ++o) {
      const int nr = gr + Dr(o), nc = gc + Dc(o);
      const bool on_grid = nr >= 0 && nr < rows && nc >= 0 && nc < cols;
      ws[o * kCells + i] = on_grid ? wst[o * plane + g] : 0.0f;
    }
  }
  __syncthreads();

  for (int k = 0; k < n_steps; ++k) {
    float v_next[kCellsPerThread];
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      if (!live[j]) continue;
      const int i = tid + j * kThreads;
      const float v = vs[vidx[j]];
      float acc = 0.0f;
#pragma unroll
      for (int o = 0; o < kNOff; ++o) {
        acc = acc + ws[o * kCells + i] * (vs[vidx[j] + Dr(o) * kVw + Dc(o)] - v);
      }
      const float i_syn = gap * acc / cnt[j];
      const float w = w_reg[j];
      const float dv = (0.04f * v * v + 5.0f * v + 140.0f - w + i_syn) * dt_cm;
      const float dw = (a * (b * v - w)) * dt_tau;
      const float v_new = v + dv;
      const float w_new = w + dw;
      const bool s = v_new >= v_th;
      v_next[j] = s ? c : v_new;
      w_reg[j] = s ? w_new + d : w_new;
      lft[j] = s ? clock0 + k : lft[j];
      spk[j] = s;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kCellsPerThread; ++j) {
      if (live[j]) vs[vidx[j]] = v_next[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kCellsPerThread; ++j) {
    if (!live[j]) continue;
    const int i = tid + j * kThreads;
    const int li = i / kTile, lj = i % kTile;
    if (li < halo || li >= halo + core || lj < halo || lj >= halo + core)
      continue;
    const size_t g = static_cast<size_t>(r0 + li) * cols + (c0 + lj);
    v_out[g] = vs[vidx[j]];
    w_out[g] = w_reg[j];
    lft_out[g] = lft[j];
    spk_out[g] = spk[j];
  }
}

ffi::Error IzhikevichStencilImpl(
    cudaStream_t stream, ffi::Buffer<ffi::F32> v, ffi::Buffer<ffi::F32> w,
    ffi::Buffer<ffi::S32> lft, ffi::Buffer<ffi::F32> wst,
    ffi::Buffer<ffi::F32> in_deg, ffi::Buffer<ffi::F32> params,
    ffi::Buffer<ffi::S32> clock, int64_t n_steps,
    ffi::ResultBuffer<ffi::F32> v_out, ffi::ResultBuffer<ffi::F32> w_out,
    ffi::ResultBuffer<ffi::S32> lft_out,
    ffi::ResultBuffer<ffi::PRED> spk_out) {
  auto dims = v.dimensions();
  if (dims.size() != 2) {
    return ffi::Error::InvalidArgument("state planes must be (rows, cols)");
  }
  const int rows = static_cast<int>(dims[0]);
  const int cols = static_cast<int>(dims[1]);
  const size_t plane = static_cast<size_t>(rows) * cols;
  if (w.element_count() != plane || lft.element_count() != plane ||
      in_deg.element_count() != plane ||
      wst.element_count() != plane * kNOff || params.element_count() != 9 ||
      clock.element_count() != 1) {
    return ffi::Error::InvalidArgument(
        "snn_izhikevich_stencil: operand sizes do not match the lattice");
  }
  if (n_steps < 1 || n_steps > kMaxSteps) {
    return ffi::Error::InvalidArgument("n_steps must be 1 to 4");
  }
  const int core = kTile - 2 * kPad * static_cast<int>(n_steps);
  auto kernel = IzhikevichStencilKernel;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSharedBytes));
  if (err == cudaSuccess) {
    dim3 grid((cols + core - 1) / core, (rows + core - 1) / core);
    kernel<<<grid, kThreads, kSharedBytes, stream>>>(
        v.typed_data(), w.typed_data(), lft.typed_data(), wst.typed_data(),
        in_deg.typed_data(), params.typed_data(), clock.typed_data(),
        v_out->typed_data(), w_out->typed_data(), lft_out->typed_data(),
        spk_out->typed_data(), rows, cols, static_cast<int>(n_steps));
    err = cudaGetLastError();
  }
  if (err != cudaSuccess) {
    return ffi::Error::Internal(std::string("snn_izhikevich_stencil: ") +
                                cudaGetErrorString(err));
  }
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    SnnIzhikevichStencil, IzhikevichStencilImpl,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()   // v
        .Arg<ffi::Buffer<ffi::F32>>()   // w
        .Arg<ffi::Buffer<ffi::S32>>()   // last_firing_time
        .Arg<ffi::Buffer<ffi::F32>>()   // stencil weights, (12, rows, cols)
        .Arg<ffi::Buffer<ffi::F32>>()   // in_deg
        .Arg<ffi::Buffer<ffi::F32>>()   // 9 uniform parameters
        .Arg<ffi::Buffer<ffi::S32>>()   // clock of the first step
        .Attr<int64_t>("n_steps")
        .Ret<ffi::Buffer<ffi::F32>>()   // v
        .Ret<ffi::Buffer<ffi::F32>>()   // w
        .Ret<ffi::Buffer<ffi::S32>>()   // last_firing_time
        .Ret<ffi::Buffer<ffi::PRED>>()  // spikes of the last step
);
