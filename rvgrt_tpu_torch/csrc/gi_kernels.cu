// The GI composite in two launches: the strided cone march, then the
// geometry-aware joint upsample fused with the composite's tail.
//
// Replaces no Pallas kernel: the JAX package leaves
// rvgrt_tpu/render/pipeline.py::gather_gi_image and gi_composite to XLA,
// which fuses their elementwise graph.  Run eagerly, the port's plain path
// (render/pipeline.py::gather_gi_image_plain, gi_composite_plain;
// render/shading.py::gather_gi, trace_cone) issues about 11 000 small
// launches a headline frame - 6 cones x 15 steps of ~100 launches each,
// and the upsample's index shifts - and the host issuing them sets the
// frame time.  These two kernels do the same arithmetic, in the same
// order, one launch each.
//
// gi_cone_march: one block of 6 warps per 32 coarse pixels, warp k marching
// cone k of each of its 32 pixels, so the cone's direction is warp-uniform.
// A lane reads the pixel's hit position and normal from the full-resolution
// G-buffer at (off + d*i, off + d*j), builds its cone direction
// (shading.cone_directions) in registers, and marches it max_cone_steps
// steps as shading.trace_cone does, one SDF byte and one GI word a step
// (or one word of the fused cone table, FUSED).  A lane stops at its
// first inactive step: nothing changes after it (the activity mask only
// ever turns off, and an inactive step adds r * 0 = 0).  The six cones'
// sums meet in shared memory and the first warp adds them in the plain
// path's order, r0 + r1 + ... + r5, then times f32(1 / num_cones).
//
// gi_upsample_composite: one thread a full-resolution pixel.  The phase
// fractions and the four clamped coarse taps come from the pixel's row and
// column (no table upload); each tap's normal code, validity and distance
// are read from the G-buffer at the tap's coarse pixel.  The weights and
// sums follow render/pipeline.py::_gi_joint_upsample tap by tap in its
// (dy, dx) order.  Mode 0 writes the three upsampled planes; modes 1 and 2
// finish gi_composite (indirect and sky ambient times albedo, scaled by the
// fog on solid hits, added and clamped), mode 2 also writing the addend.
// d == 1 reads the cone kernel's full-resolution output unchanged, as the
// plain path skips its upsample there.
//
// Bit for bit with the plain path on the card: every float operation in
// its order, no FMA (-fmad=false), the Python constants as the f32 torch
// rounds them to, torch.floor(x).to(int32) as (int)floorf(x), torch's
// flooring integer //, torch's NaN-propagating clamps.
//
// What bounds them on the H100: neither moves much.  The upsample reads
// about 61 B and writes 12-24 B a full-resolution pixel (2.1 MB of colour
// out at the headline's checker grid, 25 MB in at native); the cone march
// is latency-bound - each step's position waits on the last step's SDF
// read - over 1 000-32 400 coarse pixels, so its design spreads the cones
// over warps to keep more reads in flight.
#include <cuda_runtime.h>
#include <stdint.h>

// Must match ops/_lib.py::GI_INT_PARAMS then GI_FLOAT_PARAMS, field for
// field.
struct GiParams {
  int h, w;          // the full-resolution G-buffer
  int d, off;        // the divisor and its phase offset d / 2
  int hc, wc;        // the coarse grid, h / d by w / d
  int steps;         // shading.max_cone_steps
  int sdf_coarseness, sdf_size_x, sdf_size_y, sdf_size_z, sdf_num_cells;
  int gi_coarseness, gi_size_x, gi_size_y, gi_size_z, gi_num_cells;
  int mode;          // upsample: 0 planes, 1 composite, 2 composite + addend
  float cur0;        // the first step's distance, gi_step_size * 2
  float step_size, max_distance, tan_angle, inv_cones;
  float rel_thresh;  // RenderConfig.gi_depth_threshold
  float gi_strength, ambient_strength, water_level;
  float sun_x, sun_y, sun_z, sun_disc_cos;
  float sun_r, sun_g, sun_b;
  float hor_r, hor_g, hor_b;
  float zen_r, zen_g, zen_b;
};

namespace {

constexpr int kCones = 6;
constexpr int kPixels = 32;  // coarse pixels a cone-march block

// torch's flooring integer division (b > 0 here)
__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.clamp_min and torch.clamp on the card: NaN passes through
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// float32(1/255), the constant of gi_grid.unpack_rgba8
__device__ __forceinline__ float byte_of(uint32_t w, int sh) {
  return (float)(int)((w >> sh) & 0xFFu) * 0x1.010102p-8f;
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ V3 lerp_half(V3 a, V3 b) {
  return {a.x + (b.x - a.x) * 0.5f, a.y + (b.y - a.y) * 0.5f,
          a.z + (b.z - a.z) * 0.5f};
}

// shading._normalize_safe
__device__ __forceinline__ V3 normalize_safe(V3 v, V3 fallback) {
  const float l = sqrtf(v.x * v.x + v.y * v.y + v.z * v.z);
  if (!(l > 1e-8f)) return fallback;
  const float inv = 1.0f / clamp_min(l, 1e-8f);
  return {v.x * inv, v.y * inv, v.z * inv};
}

// cone k of shading.cone_directions(n)
__device__ __forceinline__ V3 cone_direction(int k, V3 up) {
  const V3 right = normalize_safe(cross(up, {0.577f, 0.577f, 0.577f}),
                                  {1.0f, 0.0f, 0.0f});
  const V3 fwd = normalize_safe(cross(up, right), {0.0f, 0.0f, 1.0f});
  switch (k) {
    case 0: return up;
    case 1: return lerp_half(up, right);
    case 2: return lerp_half(up, {-right.x, -right.y, -right.z});
    case 3: return lerp_half(up, fwd);
    case 4: return lerp_half(up, {-fwd.x, -fwd.y, -fwd.z});
    default: return lerp_half(up, lerp_half(right, fwd));
  }
}

// gi_grid.cell_index of the GI cell holding floor((vx, vy, vz)), clamped
// as sample_at_world and sample_cone_table clamp it; `ok` its bounds test
__device__ __forceinline__ int gi_cell(const GiParams& p, int vx, int vy,
                                       int vz, bool* ok) {
  const int c = p.gi_coarseness;
  const int gx = floor_div(vx, c), gy = floor_div(vy, c),
            gz = floor_div(vz, c);
  *ok = gx >= 0 && gx < p.gi_size_x && gy >= 0 && gy < p.gi_size_y &&
        gz >= 0 && gz < p.gi_size_z;
  const int idx = clampi(gz, 0, p.gi_size_z - 1) * (p.gi_size_x * p.gi_size_y) +
                  clampi(gy, 0, p.gi_size_y - 1) * p.gi_size_x +
                  clampi(gx, 0, p.gi_size_x - 1);
  return clampi(idx, 0, p.gi_num_cells - 1);
}

// sdf.sample_sdf_at_voxel's coarse cell
__device__ __forceinline__ int sdf_cell(const GiParams& p, int vx, int vy,
                                        int vz) {
  const int c = p.sdf_coarseness;
  const int cx = clampi(floor_div(vx, c), 0, p.sdf_size_x - 1);
  const int cy = clampi(floor_div(vy, c), 0, p.sdf_size_y - 1);
  const int cz = clampi(floor_div(vz, c), 0, p.sdf_size_z - 1);
  const int idx = cz * (p.sdf_size_x * p.sdf_size_y) + cy * p.sdf_size_x + cx;
  return clampi(idx, 0, p.sdf_num_cells - 1);
}

// shading.trace_cone for one cone
template <bool FUSED>
__device__ __forceinline__ void march(const GiParams& p, V3 o, V3 dir,
                                      const uint8_t* __restrict__ sdf,
                                      const uint32_t* __restrict__ words,
                                      float* out_r, float* out_g,
                                      float* out_b) {
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_a = 0.0f;
  float cur = p.cur0;
  for (int s = 0; s < p.steps; ++s) {
    if (!(acc_a <= 0.99f && cur <= p.max_distance)) break;
    const float cx = o.x + dir.x * cur;
    const float cy = o.y + dir.y * cur;
    const float cz = o.z + dir.z * cur;
    const int vx = (int)floorf(cx), vy = (int)floorf(cy),
              vz = (int)floorf(cz);
    bool ok;
    const uint32_t word = __ldg(words + gi_cell(p, vx, vy, vz, &ok));
    float a, scene_dist;
    if (FUSED) {
      a = 1.0f;
      scene_dist = (float)(int)(word >> 24) * (float)p.sdf_coarseness;
    } else {
      a = byte_of(word, 24);
      scene_dist = (float)(int)__ldg(sdf + sdf_cell(p, vx, vy, vz)) *
                   (float)p.sdf_coarseness;
    }
    const float r = byte_of(word, 0), g = byte_of(word, 8),
                b = byte_of(word, 16);
    const float cone_w = cur * p.tan_angle;
    const bool occluded = scene_dist < cone_w;
    if (occluded) acc_a = 1.0f;
    const float blend = (!occluded && ok) ? (1.0f - acc_a) * a : 0.0f;
    acc_r = acc_r + r * blend;
    acc_g = acc_g + g * blend;
    acc_b = acc_b + b * blend;
    acc_a = acc_a + blend;
    if (!occluded) cur = cur + clamp_min(cone_w * 0.5f, p.step_size);
  }
  *out_r = acc_r;
  *out_g = acc_g;
  *out_b = acc_b;
}

template <bool FUSED>
__global__ void __launch_bounds__(kCones * kPixels)
    cone_march_kernel(GiParams p, const float* __restrict__ px,
                      const float* __restrict__ py,
                      const float* __restrict__ pz,
                      const float* __restrict__ nx,
                      const float* __restrict__ ny,
                      const float* __restrict__ nz,
                      const uint8_t* __restrict__ sdf,
                      const uint32_t* __restrict__ words,
                      float* __restrict__ out) {
  __shared__ float part[kCones][3][kPixels];
  const int lane = threadIdx.x % kPixels;
  const int cone = threadIdx.x / kPixels;
  const int n = p.hc * p.wc;
  const int i = blockIdx.x * kPixels + lane;
  float r = 0.0f, g = 0.0f, b = 0.0f;
  if (i < n) {
    const int src = (p.off + p.d * (i / p.wc)) * p.w + p.off +
                    p.d * (i % p.wc);
    const V3 o = {px[src], py[src], pz[src]};
    const V3 dir = cone_direction(cone, {nx[src], ny[src], nz[src]});
    march<FUSED>(p, o, dir, sdf, words, &r, &g, &b);
  }
  part[cone][0][lane] = r;
  part[cone][1][lane] = g;
  part[cone][2][lane] = b;
  __syncthreads();
  if (cone != 0 || i >= n) return;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float t = part[0][k][lane];
#pragma unroll
    for (int c = 1; c < kCones; ++c) t = t + part[c][k][lane];
    out[k * n + i] = t * p.inv_cones;
  }
}

// render/pipeline.py::_normal_code
__device__ __forceinline__ int normal_code(float x, float y, float z) {
  if (x != 0.0f) return x > 0.0f ? 1 : 0;
  if (y != 0.0f) return y > 0.0f ? 3 : 2;
  if (z != 0.0f) return z > 0.0f ? 5 : 4;
  return 6;
}

__global__ void upsample_composite_kernel(
    GiParams p, const float* __restrict__ coarse,
    const uint8_t* __restrict__ hit, const float* __restrict__ t,
    const float* __restrict__ nx, const float* __restrict__ ny,
    const float* __restrict__ nz, const float* __restrict__ py,
    const float* __restrict__ alb_r, const float* __restrict__ alb_g,
    const float* __restrict__ alb_b, const float* __restrict__ fog,
    const float* __restrict__ color, float* __restrict__ out,
    float* __restrict__ addend) {
  const int n = p.h * p.w;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int nc = p.hc * p.wc;
  float gi[3];
  if (p.d == 1) {
#pragma unroll
    for (int k = 0; k < 3; ++k) gi[k] = coarse[k * nc + i];
  } else {
    const int y = i / p.w, x = i % p.w;
    const int ry = y % p.d, rx = x % p.d;
    const float fy = (float)((ry - p.off + p.d) % p.d) / (float)p.d;
    const float fx = (float)((rx - p.off + p.d) % p.d) / (float)p.d;
    // the nearest coarse sample at or before the pixel, per axis
    const int iy0 = y / p.d - (ry < p.off ? 1 : 0);
    const int ix0 = x / p.d - (rx < p.off ? 1 : 0);
    const int code = normal_code(nx[i], ny[i], nz[i]);
    const float t_full = t[i];
    const float reach = p.rel_thresh * t_full + 2.0f;
    float den1 = 0.0f, den2 = 0.0f, num1[3], num2[3];
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const float wy = dy ? fy : 1.0f - fy;
      const int cy = clampi(iy0 + dy, 0, p.hc - 1);
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const float wx = dx ? fx : 1.0f - fx;
        const int cx = clampi(ix0 + dx, 0, p.wc - 1);
        const int src = (p.off + p.d * cy) * p.w + p.off + p.d * cx;
        const float wb = wy * wx * (hit[src] ? 1.0f : 0.0f);
        const bool sim = normal_code(nx[src], ny[src], nz[src]) == code &&
                         fabsf(t[src] - t_full) <= reach;
        const float w1 = wb * (sim ? 1.0f : 0.0f);
        const int c = cy * p.wc + cx;
        const bool first = dy == 0 && dx == 0;
        den1 = first ? w1 : den1 + w1;
        den2 = first ? wb : den2 + wb;
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          const float e = coarse[k * nc + c];
          num1[k] = first ? w1 * e : num1[k] + w1 * e;
          num2[k] = first ? wb * e : num2[k] + wb * e;
        }
      }
    }
    const bool use1 = den1 > 1e-4f, use2 = den2 > 1e-4f;
    const float d1 = clamp_min(den1, 1e-6f), d2 = clamp_min(den2, 1e-6f);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float v1 = num1[k] / d1, v2 = num2[k] / d2;
      gi[k] = use1 ? v1 : (use2 ? v2 : 0.0f);
    }
  }
  if (p.mode == 0) {
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k * n + i] = gi[k];
    return;
  }
  // gi_composite's tail: shading.sample_sky at the normal, then
  // (indirect + ambient) * (fog on solid hits, else 0), added and clamped
  const float sx = nx[i], sy = ny[i], sz = nz[i];
  const float sun_dot = sx * p.sun_x + sy * p.sun_y + sz * p.sun_z;
  const float tt = clamp(0.5f * (sy + 1.0f), 0.0f, 1.0f);
  const bool disc = sun_dot > p.sun_disc_cos;
  const float sky[3] = {
      disc ? p.sun_r : p.hor_r + (p.zen_r - p.hor_r) * tt,
      disc ? p.sun_g : p.hor_g + (p.zen_g - p.hor_g) * tt,
      disc ? p.sun_b : p.hor_b + (p.zen_b - p.hor_b) * tt};
  const float alb[3] = {alb_r[i], alb_g[i], alb_b[i]};
  const bool solid = hit[i] && !(py[i] < p.water_level);
  const float scale = solid ? fog[i] : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float indirect = gi[k] * (alb[k] * p.gi_strength);
    const float ambient = sky[k] * (alb[k] * p.ambient_strength);
    const float add = (indirect + ambient) * scale;
    out[3 * i + k] = clamp(color[3 * i + k] + add, 0.0f, 1.0f);
    if (p.mode == 2) addend[3 * i + k] = add;
  }
}

}  // namespace

extern "C" int rvgrt_gi_cone_march(GiParams p, int fused, const void* px,
                                   const void* py, const void* pz,
                                   const void* nx, const void* ny,
                                   const void* nz, const void* sdf,
                                   const void* words, void* out,
                                   void* stream) {
  const int n = p.hc * p.wc;
  if (n <= 0) return 0;
  const unsigned grid = (unsigned)((n + kPixels - 1) / kPixels);
  const cudaStream_t s = (cudaStream_t)stream;
  if (fused)
    cone_march_kernel<true><<<grid, kCones * kPixels, 0, s>>>(
        p, (const float*)px, (const float*)py, (const float*)pz,
        (const float*)nx, (const float*)ny, (const float*)nz,
        (const uint8_t*)sdf, (const uint32_t*)words, (float*)out);
  else
    cone_march_kernel<false><<<grid, kCones * kPixels, 0, s>>>(
        p, (const float*)px, (const float*)py, (const float*)pz,
        (const float*)nx, (const float*)ny, (const float*)nz,
        (const uint8_t*)sdf, (const uint32_t*)words, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int rvgrt_gi_upsample_composite(
    GiParams p, const void* coarse, const void* hit, const void* t,
    const void* nx, const void* ny, const void* nz, const void* py,
    const void* alb_r, const void* alb_g, const void* alb_b, const void* fog,
    const void* color, void* out, void* addend, void* stream) {
  const int n = p.h * p.w;
  if (n <= 0) return 0;
  const int block = 256;
  upsample_composite_kernel<<<(unsigned)((n + block - 1) / block), block, 0,
                              (cudaStream_t)stream>>>(
      p, (const float*)coarse, (const uint8_t*)hit, (const float*)t,
      (const float*)nx, (const float*)ny, (const float*)nz, (const float*)py,
      (const float*)alb_r, (const float*)alb_g, (const float*)alb_b,
      (const float*)fog, (const float*)color, (float*)out, (float*)addend);
  return (int)cudaGetLastError();
}
