// Hand-written Hopper (sm_90a) kernels for the two Pallas post kernels of
// vk_renderer_tpu/ops/post.py, bound to PyTorch through a plain C interface
// (ctypes; vk_renderer_tpu_torch/ops/post.py):
//
//   tonemap_kernel   replaces post.py::_tonemap_kernel  (Reinhard c/(c+1),
//                    then exp(log(m) * (1/2.2)); shaders/tonemap.comp)
//   gradient_kernel  replaces post.py::_gradient_kernel (vertical
//                    top*(1-blend) + bottom*blend, blend = (y + row0) *
//                    inv_h; shaders/gradient_color.comp).  row0 places an
//                    h-row strip at row row0 of a taller frame, so a
//                    strip's rows equal the whole frame's bit for bit.
//
// Both work on planar f32[3, H, W] images.  Pallas cuts the image into
// (block_h = 64)-row blocks and pads the last one; here each kernel is a
// grid-stride pass that checks every index against the image's extent, so
// nothing is written out of range at any H.
//
// What bounds them on this card: memory.  The tonemap reads and writes
// 4 bytes per element and computes an add, a divide, a multiply, a logf
// and an expf (some 40 instructions) on it — at 3.35 TB/s the bytes take
// longer than the arithmetic at the f32 rate; the gradient only writes.
// So the design moves each byte once, with 16-byte float4 loads and
// stores where the layout allows (a scalar loop takes the rest): the
// tonemap over the flat array, the gradient whenever W is a multiple of 4.
//
// Exactness: the build passes --fmad=false and the arithmetic is spelled
// with __fmul_rn / __fadd_rn / __fdiv_rn in the Pallas kernels' order, so
// the gradient equals its plain PyTorch version bit for bit; the tonemap's
// logf / expf are CUDA's (<= 1 and 2 ulp), so it is held to its plain
// version within a few ulp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;   // SMs x resident 256-thread blocks
// f32(1 / 2.2), rounded once from the double quotient as Python's
// INV_GAMMA is before it meets an f32 array
constexpr float kInvGamma = static_cast<float>(1.0 / 2.2);

__device__ __forceinline__ float tonemap1(float c) {
    const float mapped = __fdiv_rn(c, __fadd_rn(c, 1.0f));
    return expf(__fmul_rn(logf(mapped), kInvGamma));
}

__global__ void __launch_bounds__(kThreads)
tonemap_kernel(const float* __restrict__ in, float* __restrict__ out,
               int64_t n, int vec4) {
    const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
    const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x
                          + threadIdx.x;
    int64_t done = 0;
    if (vec4) {
        const int64_t n4 = n / 4;
        const float4* in4 = reinterpret_cast<const float4*>(in);
        float4* out4 = reinterpret_cast<float4*>(out);
        for (int64_t i = first; i < n4; i += stride) {
            float4 v = in4[i];
            v.x = tonemap1(v.x);
            v.y = tonemap1(v.y);
            v.z = tonemap1(v.z);
            v.w = tonemap1(v.w);
            out4[i] = v;
        }
        done = n4 * 4;
    }
    for (int64_t i = done + first; i < n; i += stride) {
        out[i] = tonemap1(in[i]);
    }
}

__device__ __forceinline__ float gradient_row(const float* top,
                                             const float* bottom,
                                             float inv_h, int row, int h,
                                             int row0) {
    const int c = row / h;
    // an integer below 2^24, so exact in f32 whatever the strip
    const float y = static_cast<float>(row - c * h + row0);
    const float blend = __fmul_rn(y, inv_h);
    return __fadd_rn(__fmul_rn(top[c], __fsub_rn(1.0f, blend)),
                     __fmul_rn(bottom[c], blend));
}

// Flat grid-stride pass over the 3*H*W outputs; row = index / W names the
// channel and the image row.  With W a multiple of 4 a float4 never
// straddles two rows, so the pass stores 16 bytes a thread.
__global__ void __launch_bounds__(kThreads)
gradient_kernel(const float* __restrict__ top,
                const float* __restrict__ bottom, float inv_h,
                float* __restrict__ out, int h, int w, int row0, int vec4) {
    const int n = 3 * h * w;
    const int stride = gridDim.x * blockDim.x;
    const int first = blockIdx.x * blockDim.x + threadIdx.x;
    if (vec4) {
        const int w4 = w / 4;
        float4* out4 = reinterpret_cast<float4*>(out);
        for (int i = first; i < n / 4; i += stride) {
            const float v = gradient_row(top, bottom, inv_h, i / w4, h,
                                         row0);
            out4[i] = make_float4(v, v, v, v);
        }
        return;
    }
    for (int i = first; i < n; i += stride) {
        out[i] = gradient_row(top, bottom, inv_h, i / w, h, row0);
    }
}

int blocks_for(int64_t work) {
    const int64_t b = (work + kThreads - 1) / kThreads;
    return static_cast<int>(b < kMaxBlocks ? (b > 0 ? b : 1) : kMaxBlocks);
}

}  // namespace

extern "C" {

int vkr_tonemap(const float* in, float* out, int64_t n, void* stream) {
    if (n <= 0) return 0;
    const int vec4 = (reinterpret_cast<uintptr_t>(in) % 16 == 0)
                     & (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    tonemap_kernel<<<blocks_for(vec4 ? n / 4 : n), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(in, out, n, vec4);
    return static_cast<int>(cudaGetLastError());
}

// The caller keeps 3*h*w below 2^31 (the indices are 32-bit) and
// row0 + h below 2^24.
int vkr_gradient(const float* top, const float* bottom, float inv_h,
                 float* out, int h, int w, int row0, void* stream) {
    if (h <= 0 || w <= 0) return 0;
    const int64_t n = 3LL * h * w;
    const int vec4 = (w % 4 == 0)
                     & (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    gradient_kernel<<<blocks_for(vec4 ? n / 4 : n), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        top, bottom, inv_h, out, h, w, row0, vec4);
    return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
