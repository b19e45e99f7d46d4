// The shading of a generation on the no-grad path: the glue between the
// generation's kernels, in two launches.
//
// Replaces no TPU kernel: on the TPU, XLA fused this elementwise glue of
// raytracer_tpu/render/renderer.py:_shade_generation into its program.  In
// PyTorch each step of it is one launch over every lane, ~200 launches a
// generation issued by the host, which set the pace of a frame.  The plain
// versions are raytracer_tpu_torch/render/renderer.py:_surface_glue and
// _lights_glue, which the CPU and a render under autograd run; this file does
// the same float32 operations in the same order, built with --fmad=false, so
// that every value it writes equals theirs on the card bit for bit (rsqrtf,
// sqrtf, expf and IEEE division as torch's CUDA kernels take them).
//
// rt_shade_surface, one thread a lane, after K3 (the texture) and K5 (the sky):
//  - Beer's law along the segment (t clamped at 1e8) gives the throughput w;
//  - the sky term on a miss;
//  - the material rows by material id (0 where the lane missed), the albedo;
//  - every light's Blinn-Phong term, the point lights, then the spot lights,
//    then the directional lights, from the scene's light tables (any count);
//  - the any-hit call's operands in its [L*N] layout (light-major): origin
//    (with the normal offset), direction, distance and active, and each
//    block's count of active shadow rays.
// rt_shade_lights, one thread a lane, after the any-hit call: the ambient term
// plus every unblocked light's, times w * albedo, plus the sky term, added
// into the frame (generation 0, whose lanes are the pixels in order) or
// written for the framebuffer scatter; block 0 also sums the surface blocks'
// counts into num_shadow and the generation's incomplete rays into
// num_incomplete.
//
// rt_shade_tex_id gathers the texture id of each lane's material for K3.
//
// Bound on the H100: bytes.  With L lights the surface reads ~85 B a lane (the
// hit record's t, id, point and normal, the generation's weight, sigma and
// flags, K3's and K5's outputs) and writes 61 + 41 L B (w, w * albedo, the sky
// term, the material rows, and per light its term and its shadow ray), for
// ~25 + 60 L float32 operations; the lights kernel reads 25 + 13 L B and
// writes 12 (or reads and writes the frame's row).  Config3 at 1080p (3
// lights, 2,073,600 lanes): ~0.6 GB for generation 0, ~0.18 ms at 3.35 TB/s.
#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kWarps = kBlock / 32;
constexpr unsigned kFullWarp = 0xffffffffu;

// pointer slots of rt_shade_surface, in the order ops/shade.py passes them
enum SurfaceIn {
  kActive, kWeight, kSigma,                            // the generation
  kHit, kT, kMatId, kPoint, kNormal,                   // the hit record
  kSky, kTex,                                          // K5's and K3's outputs (kTex null: no textures)
  kDiffuse, kReflection, kTransmittance, kIor,         // the material table
  kCamPos,
  kPlPos, kPlColour,                                   // point lights
  kSlPos, kSlColour, kSlNegDir, kSlInner, kSlOuter,    // spot lights
  kDlNegDir, kDlColour,                                // directional lights
  kNumSurfaceIn
};
enum SurfaceOut {
  kW, kReflC, kTransC, kIorOut, kMiss, kWAlbedo, kShadowActive,
  kContribs, kShOrigin, kShDir, kShDist, kShActive, kCounts,
  kNumSurfaceOut
};
// pointer slots of rt_shade_lights
enum LightsIn {
  kLMiss, kLWAlbedo, kLShadowActive, kLContribs, kLBlocked, kLAmbient, kLCounts,
  kLNumShadowIn, kLIncompleteIn, kLTraceIncomplete, kLShadowIncomplete,
  kLFrame, kLOut, kLNumShadowOut, kLIncompleteOut,
  kNumLights
};

struct SurfaceArgs {
  const void* in[kNumSurfaceIn];
  void* out[kNumSurfaceOut];
};

struct LightsArgs {
  const void* p[kNumLights];
};

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 load3(const void* base, long long i) {
  const float* p = (const float*)base + 3 * i;
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ void store3(void* base, long long i, V3 v) {
  float* p = (float*)base + 3 * i;
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

__device__ __forceinline__ V3 operator+(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 operator-(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 operator*(V3 a, V3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }
__device__ __forceinline__ V3 operator*(float s, V3 a) { return {s * a.x, s * a.y, s * a.z}; }
__device__ __forceinline__ V3 operator/(V3 a, float s) { return {a.x / s, a.y / s, a.z / s}; }

// vm.dot: the component products summed left to right
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ V3 select(bool m, V3 a) {
  return m ? a : V3{0.0f, 0.0f, 0.0f};
}

// vm.normalize(a, eps=1e-20): a * rsqrt(|a|^2 + eps), the eps rounded from
// double as torch rounds a Python float
__device__ __forceinline__ V3 normalize(V3 a) {
  const float eps = (float)1e-20;
  return rsqrtf(dot(a, a) + eps) * a;
}

// shading.blinn_phong's intensity (Light.h:12-26): where(N.L > 0, N.L + (N.H)^128, 0)
__device__ __forceinline__ float blinn_phong(V3 normal, V3 to_light, V3 to_camera) {
  const float intensity = dot(normal, to_light);
  float specular = dot(normal, normalize(to_light + to_camera));
  for (int k = 0; k < 7; ++k) specular = specular * specular;  // vm.pow2_128
  return intensity > 0.0f ? intensity + specular : 0.0f;
}

// torch.clamp_max keeps a NaN
__device__ __forceinline__ float clamp_max(float x, float hi) { return isnan(x) ? x : fminf(x, hi); }

// The sum over the block of each thread's v, by thread 0 (every thread calls it)
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int warp_sums[kWarps];
  v = __reduce_add_sync(kFullWarp, v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;
}

__global__ void __launch_bounds__(kBlock)
tex_id_kernel(const bool* __restrict__ hit, const int* __restrict__ material_id,
              const int* __restrict__ mat_texture, int n, int* __restrict__ tex_id) {
  const int i = blockIdx.x * kBlock + threadIdx.x;
  if (i < n) tex_id[i] = mat_texture[hit[i] ? material_id[i] : 0];
}

__global__ void __launch_bounds__(kBlock)
surface_kernel(SurfaceArgs a, int n, int n_point, int n_spot, int n_dir, int use_offset,
               float offset) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  const int n_lights = n_point + n_spot + n_dir;
  int traced = 0;
  if (i < n) {
    const bool hit = ((const bool*)a.in[kHit])[i];
    // Beer's law along this segment
    const float t_seg = clamp_max(hit ? ((const float*)a.in[kT])[i] : INFINITY, 1.0e8f);
    const V3 sigma = load3(a.in[kSigma], i);
    const V3 beer = {expf(sigma.x * t_seg), expf(sigma.y * t_seg), expf(sigma.z * t_seg)};
    const V3 w = load3(a.in[kWeight], i) * beer;
    store3(a.out[kW], i, w);

    // the sky on a miss
    const bool miss = ((const bool*)a.in[kActive])[i] && !hit;
    store3(a.out[kMiss], i, select(miss, w * load3(a.in[kSky], i)));

    // the material rows and the albedo
    const int mid = hit ? ((const int*)a.in[kMatId])[i] : 0;
    store3(a.out[kReflC], i, load3(a.in[kReflection], mid));
    store3(a.out[kTransC], i, load3(a.in[kTransmittance], mid));
    ((float*)a.out[kIorOut])[i] = ((const float*)a.in[kIor])[mid];
    V3 albedo = load3(a.in[kDiffuse], mid);
    if (a.in[kTex] != nullptr) albedo = albedo * load3(a.in[kTex], i);
    albedo = select(hit, albedo);
    const bool shadow_active = dot(albedo, albedo) > 0.0f;  // implies hit
    ((bool*)a.out[kShadowActive])[i] = shadow_active;
    store3(a.out[kWAlbedo], i, w * albedo);

    // every light's term and shadow ray, light-major: slot l * n + i
    const V3 point = load3(a.in[kPoint], i);
    const V3 normal = load3(a.in[kNormal], i);
    const V3 to_camera = normalize(load3(a.in[kCamPos], 0) - point);
    const V3 origin = use_offset ? point + offset * normal : point;
    for (int l = 0; l < n_lights; ++l) {
      V3 to_light, c;
      float dist;
      if (l < n_point + n_spot) {  // PointLight.h:9-11, SpotLight.h:17-33
        const bool spot = l >= n_point;
        const int k = spot ? l - n_point : l;
        to_light = load3(spot ? a.in[kSlPos] : a.in[kPlPos], k) - point;
        const float d2 = dot(to_light, to_light);
        dist = sqrtf(d2);
        to_light = to_light / dist;
        const float bp = blinn_phong(normal, to_light, to_camera);
        c = (bp * load3(spot ? a.in[kSlColour] : a.in[kPlColour], k)) / d2;
        if (spot) {
          const float outer = ((const float*)a.in[kSlOuter])[k];
          const float inner = ((const float*)a.in[kSlInner])[k];
          const float d = dot(to_light, load3(a.in[kSlNegDir], k));
          float falloff = (d - outer) / (inner - outer);
          falloff = falloff > 1.0f ? 1.0f : falloff;
          falloff = d > outer ? falloff : 0.0f;
          c = falloff * c;
        }
      } else {  // DirectionalLight.h:9-11
        const int k = l - n_point - n_spot;
        to_light = load3(a.in[kDlNegDir], k);
        dist = INFINITY;
        c = blinn_phong(normal, to_light, to_camera) * load3(a.in[kDlColour], k);
      }
      const long long slot = (long long)l * n + i;
      store3(a.out[kContribs], slot, c);
      store3(a.out[kShOrigin], slot, origin);
      store3(a.out[kShDir], slot, to_light);
      ((float*)a.out[kShDist])[slot] = dist;
      const bool active = shadow_active && dot(c, c) > 0.0f;
      ((bool*)a.out[kShActive])[slot] = active;
      traced += active;
    }
  }
  if (n_lights > 0) {  // uniform over the launch
    const int total = block_sum(traced);
    if (threadIdx.x == 0) ((int*)a.out[kCounts])[blockIdx.x] = total;
  }
}

__global__ void __launch_bounds__(kBlock)
lights_kernel(LightsArgs a, int n, int n_lights, int n_counts) {
  const long long i = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (i < n) {
    const float ambient = *(const float*)a.p[kLAmbient];
    V3 acc = {0.0f + ambient, 0.0f + ambient, 0.0f + ambient};
    const bool shadow_active = n_lights > 0 && ((const bool*)a.p[kLShadowActive])[i];
    for (int l = 0; l < n_lights; ++l) {
      const long long slot = (long long)l * n + i;
      const bool lit = shadow_active && !((const bool*)a.p[kLBlocked])[slot];
      acc = acc + select(lit, load3(a.p[kLContribs], slot));
    }
    const V3 c = load3(a.p[kLMiss], i) + load3(a.p[kLWAlbedo], i) * acc;
    if (a.p[kLFrame] != nullptr) {
      float* row = (float*)a.p[kLFrame] + 3 * i;
      row[0] = row[0] + c.x;
      row[1] = row[1] + c.y;
      row[2] = row[2] + c.z;
    } else {
      store3(const_cast<void*>(a.p[kLOut]), i, c);
    }
  }
  if (blockIdx.x != 0) return;  // uniform over the block
  int traced = 0;
  if (n_lights > 0)
    for (int k = threadIdx.x; k < n_counts; k += kBlock) traced += ((const int*)a.p[kLCounts])[k];
  const int total = block_sum(traced);
  if (threadIdx.x == 0) {
    const int* shadow_inc = (const int*)a.p[kLShadowIncomplete];
    *(int*)a.p[kLIncompleteOut] = *(const int*)a.p[kLIncompleteIn] +
                                  *(const int*)a.p[kLTraceIncomplete] +
                                  (shadow_inc != nullptr ? *shadow_inc : 0);
    if (n_lights > 0) *(int*)a.p[kLNumShadowOut] = *(const int*)a.p[kLNumShadowIn] + total;
  }
}

}  // namespace

extern "C" int rt_shade_tex_id(const void* hit, const void* material_id, const void* mat_texture,
                               int n, void* tex_id, void* stream) {
  tex_id_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      (const bool*)hit, (const int*)material_id, (const int*)mat_texture, n, (int*)tex_id);
  return (int)cudaGetLastError();
}

// ptrs: the kNumSurfaceIn inputs, then the kNumSurfaceOut outputs (the light
// outputs are not written when there is no light, and may be null); counts
// holds one int32 a block
extern "C" int rt_shade_surface(const void* const* ptrs, int n, int n_point, int n_spot,
                                int n_dir, int use_offset, float offset, void* stream) {
  SurfaceArgs a;
  for (int k = 0; k < kNumSurfaceIn; ++k) a.in[k] = ptrs[k];
  for (int k = 0; k < kNumSurfaceOut; ++k) a.out[k] = const_cast<void*>(ptrs[kNumSurfaceIn + k]);
  surface_kernel<<<rt::grid_for(n, kBlock), kBlock, 0, (cudaStream_t)stream>>>(
      a, n, n_point, n_spot, n_dir, use_offset, offset);
  return (int)cudaGetLastError();
}

// ptrs: the kNumLights slots; the frame (a dense add) or out (for the
// scatter) is null.  Without a light the light slots are neither read nor
// written and the shadow call's incomplete count is null.  n_counts: the
// surface launch's blocks, whose counts block 0 sums.
extern "C" int rt_shade_lights(const void* const* ptrs, int n, int n_lights, int n_counts,
                               void* stream) {
  LightsArgs a;
  for (int k = 0; k < kNumLights; ++k) a.p[k] = ptrs[k];
  const unsigned grid = n > 0 ? rt::grid_for(n, kBlock) : 1u;
  lights_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(a, n, n_lights, n_counts);
  return (int)cudaGetLastError();
}
