// K8: FXAA post pass, linear [H,W,3] in, gamma-space [H,W,3] out.
//
// Replaces raytracer_tpu/ops/fxaa.py:fxaa (JAX); the plain PyTorch version is
// raytracer_tpu_torch/ops/fxaa.py:fxaa_plain.  Semantics, step for step:
//   - every texel read is clip(x, 0, 1) ** (1/2.2) of the linear image;
//   - luma = r*0.299 + g*0.587 + b*0.114 of the centre and the four diagonal
//     neighbours, clamped to the edge;
//   - blur direction from the diagonal luma gradient, scaled by
//     1 / (min(|dir|) + max(1/128, mean luma / 8)) and clamped to +-8 px;
//   - four bilinear taps at k = 1/3-1/2, 2/3-1/2, -1/2, 1/2 along it, with the
//     tap coordinates clamped to the image;
//   - the 4-tap mean unless its luma leaves the neighbourhood's [min, max],
//     then the 2-tap mean.
// Constants are rounded from double to float32, as JAX's weak types round
// them; built with --fmad=false, so each step rounds as the plain version's.
//
// Bound on the H100: bytes.  The image is read once (12 B per pixel; the
// taps' re-reads of neighbours come from L1/L2) and written once (12 B),
// against ~300 float operations per pixel, 21 of them powf.  One thread per
// output pixel, gamma applied per fetched texel; right and simple.
#include "common.cuh"

namespace {

const float kInvGamma = (float)(1.0 / 2.2);
const float kLumaR = (float)0.299, kLumaG = (float)0.587, kLumaB = (float)0.114;
const float kReduceMin = (float)(1.0 / 128.0), kReduceMul = (float)(1.0 / 8.0);
const float kSpanMax = 8.0f;

struct Rgb {
  float r, g, b;
};

struct Image {
  const float* data;
  int h, w;

  // gamma-space texel at integer coordinates already inside the image
  __device__ Rgb at(int y, int x) const {
    const float* p = data + 3ll * ((long long)y * w + x);
    return {gamma(p[0]), gamma(p[1]), gamma(p[2])};
  }

  __device__ static float gamma(float x) {
    return powf(rt::nan_min(rt::nan_max(x, 0.0f), 1.0f), kInvGamma);
  }

  __device__ Rgb clamped(int y, int x) const {
    return at(min(max(y, 0), h - 1), min(max(x, 0), w - 1));
  }

  // fxaa._bilinear_tap
  __device__ Rgb bilinear(float x, float y) const {
    x = rt::nan_min(rt::nan_max(x, 0.0f), (float)w - 1.0f);
    y = rt::nan_min(rt::nan_max(y, 0.0f), (float)h - 1.0f);
    int x0 = (int)floorf(x), y0 = (int)floorf(y);
    int x1 = min(x0 + 1, w - 1), y1 = min(y0 + 1, h - 1);
    float fx = x - (float)x0, fy = y - (float)y0;
    float gx = 1.0f - fx, gy = 1.0f - fy;
    Rgb p00 = at(y0, x0), p10 = at(y0, x1), p01 = at(y1, x0), p11 = at(y1, x1);
    return {p00.r * gx * gy + p10.r * fx * gy + p01.r * gx * fy + p11.r * fx * fy,
            p00.g * gx * gy + p10.g * fx * gy + p01.g * gx * fy + p11.g * fx * fy,
            p00.b * gx * gy + p10.b * fx * gy + p01.b * gx * fy + p11.b * fx * fy};
  }
};

__device__ __forceinline__ float luma(Rgb c) { return c.r * kLumaR + c.g * kLumaG + c.b * kLumaB; }

__device__ __forceinline__ Rgb mean2(Rgb a, Rgb b) {
  return {0.5f * (a.r + b.r), 0.5f * (a.g + b.g), 0.5f * (a.b + b.b)};
}

__global__ void fxaa_kernel(Image img, float* __restrict__ out) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)img.h * img.w) return;
  int y = (int)(i / img.w), x = (int)(i % img.w);

  float l_tl = luma(img.clamped(y - 1, x - 1));
  float l_tr = luma(img.clamped(y - 1, x + 1));
  float l_bl = luma(img.clamped(y + 1, x - 1));
  float l_br = luma(img.clamped(y + 1, x + 1));
  float l_m = luma(img.at(y, x));

  float l_min = rt::nan_min(rt::nan_min(rt::nan_min(l_tl, l_tr), rt::nan_min(l_bl, l_br)), l_m);
  float l_max = rt::nan_max(rt::nan_max(rt::nan_max(l_tl, l_tr), rt::nan_max(l_bl, l_br)), l_m);

  float dir_x = (l_bl + l_br) - (l_tl + l_tr);
  float dir_y = (l_tl + l_bl) - (l_tr + l_br);
  float reduce = rt::nan_max((l_tl + l_tr + l_bl + l_br) * 0.25f * kReduceMul, kReduceMin);
  float adjust = 1.0f / (rt::nan_min(fabsf(dir_x), fabsf(dir_y)) + reduce);
  dir_x = rt::nan_min(rt::nan_max(dir_x * adjust, -kSpanMax), kSpanMax);
  dir_y = rt::nan_min(rt::nan_max(dir_y * adjust, -kSpanMax), kSpanMax);

  float xf = (float)x, yf = (float)y;
  const float k0 = (float)(1.0 / 3.0 - 0.5), k1 = (float)(2.0 / 3.0 - 0.5);
  Rgb ra = mean2(img.bilinear(xf + dir_x * k0, yf + dir_y * k0),
                 img.bilinear(xf + dir_x * k1, yf + dir_y * k1));
  Rgb rb = mean2(img.bilinear(xf + dir_x * -0.5f, yf + dir_y * -0.5f),
                 img.bilinear(xf + dir_x * 0.5f, yf + dir_y * 0.5f));
  Rgb res = mean2(ra, rb);
  float l_res = luma(res);
  Rgb o = (l_res < l_min || l_res > l_max) ? ra : res;
  out[3 * i + 0] = o.r;
  out[3 * i + 1] = o.g;
  out[3 * i + 2] = o.b;
}

}  // namespace

// image, out: [h,w,3] f32, row-major.
extern "C" int rt_fxaa(const void* image, int h, int w, void* out, void* stream) {
  constexpr int kBlock = 256;
  long long n = (long long)h * w;
  unsigned grid = (unsigned)((n + kBlock - 1) / kBlock);
  fxaa_kernel<<<grid, kBlock, 0, (cudaStream_t)stream>>>(Image{(const float*)image, h, w},
                                                         (float*)out);
  return (int)cudaGetLastError();
}
