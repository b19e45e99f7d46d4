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
// Bound on the H100: bytes.  The image is read once (12 B per pixel) and
// written once (12 B), against ~300 float operations per pixel.
//
// A thread per pixel that gammas each of its 21 texel reads anew runs 63 powf
// a pixel (the first design, removed; PERF.md section 6).  tile_kernel's block
// of 32x16 pixels first writes the gamma-space texels of its pixels and a halo
// of 4 before and 5 after (41x25, with their luma) into shared memory, each
// once; every pixel then runs the plain version's arithmetic on them.  Left
// undone: ~2 gamma texels a pixel remain (3 powf each), and the tile's loads
// and the taps' reads of shared memory are not vectorised.
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
};

__device__ __forceinline__ float luma(Rgb c) { return c.r * kLumaR + c.g * kLumaG + c.b * kLumaB; }

__device__ __forceinline__ Rgb mean2(Rgb a, Rgb b) {
  return {0.5f * (a.r + b.r), 0.5f * (a.g + b.g), 0.5f * (a.b + b.b)};
}

// A block of kTileW x kTileH pixels first writes the gamma-space texels (and
// their luma) of its pixels and a halo into shared memory, each texel once,
// with Image::gamma's powf on the same inputs; then every pixel runs the plain
// version's expressions in its order on those values.  A finite tap direction
// is clamped to +-8 px and the taps sit at k in [-1/2, 1/2] along it, so a
// tap's texels lie within kHaloLo before and kHaloHi after the pixel (x1 = x0
// + 1 adds the one); a tap outside the tile (a NaN direction, from a NaN
// centre or diagonal) reads the image with Image::at.

constexpr int kTileW = 32, kTileH = 16;  // pixels a block
constexpr int kHaloLo = 4, kHaloHi = 5;
constexpr int kTw = kTileW + kHaloLo + kHaloHi, kTh = kTileH + kHaloLo + kHaloHi;
constexpr int kTexels = kTw * kTh;

struct Tile {
  float r[kTexels], g[kTexels], b[kTexels], l[kTexels];
};

// A block's tile and the image coordinates of its texel 0 (not clamped).
struct TileAt {
  const Tile& t;
  int x0, y0;

  __device__ bool holds(int y, int x) const {
    return (unsigned)(x - x0) < (unsigned)kTw && (unsigned)(y - y0) < (unsigned)kTh;
  }
  __device__ int index(int y, int x) const { return (y - y0) * kTw + (x - x0); }
  __device__ Rgb rgb(int k) const { return {t.r[k], t.g[k], t.b[k]}; }
};

// fxaa._bilinear_tap on the tile, the image's texels outside it
__device__ __forceinline__ Rgb tile_bilinear(const TileAt& tl, const Image& img, float x,
                                             float y) {
  x = rt::nan_min(rt::nan_max(x, 0.0f), (float)img.w - 1.0f);
  y = rt::nan_min(rt::nan_max(y, 0.0f), (float)img.h - 1.0f);
  int x0 = (int)floorf(x), y0 = (int)floorf(y);
  int x1 = min(x0 + 1, img.w - 1), y1 = min(y0 + 1, img.h - 1);
  float fx = x - (float)x0, fy = y - (float)y0;
  float gx = 1.0f - fx, gy = 1.0f - fy;
  Rgb p00, p10, p01, p11;
  if (tl.holds(y0, x0) && tl.holds(y1, x1)) {
    const int k = tl.index(y0, x0), dx = x1 - x0, dy = (y1 - y0) * kTw;
    p00 = tl.rgb(k), p10 = tl.rgb(k + dx), p01 = tl.rgb(k + dy), p11 = tl.rgb(k + dy + dx);
  } else {
    p00 = img.at(y0, x0), p10 = img.at(y0, x1), p01 = img.at(y1, x0), p11 = img.at(y1, x1);
  }
  return {p00.r * gx * gy + p10.r * fx * gy + p01.r * gx * fy + p11.r * fx * fy,
          p00.g * gx * gy + p10.g * fx * gy + p01.g * gx * fy + p11.g * fx * fy,
          p00.b * gx * gy + p10.b * fx * gy + p01.b * gx * fy + p11.b * fx * fy};
}

__global__ void __launch_bounds__(kTileW * kTileH) tile_kernel(Image img,
                                                               float* __restrict__ out) {
  __shared__ Tile tile;
  const int bx = blockIdx.x * kTileW, by = blockIdx.y * kTileH;
  const TileAt tl{tile, bx - kHaloLo, by - kHaloLo};
  // texel k of the tile is Image::clamped at (tl.y0 + k / kTw, tl.x0 + k % kTw):
  // neighbouring threads on neighbouring texels of a row
  for (int k = threadIdx.y * kTileW + threadIdx.x; k < kTexels; k += kTileW * kTileH) {
    const int ty = k / kTw;
    const Rgb c = img.clamped(tl.y0 + ty, tl.x0 + (k - ty * kTw));
    tile.r[k] = c.r;
    tile.g[k] = c.g;
    tile.b[k] = c.b;
    tile.l[k] = luma(c);
  }
  __syncthreads();
  const int x = bx + threadIdx.x, y = by + threadIdx.y;
  if (x >= img.w || y >= img.h) return;

  // the clamped diagonals: the tile's texels at (y +- 1, x +- 1) hold them
  const int m = tl.index(y, x);
  float l_tl = tile.l[m - kTw - 1];
  float l_tr = tile.l[m - kTw + 1];
  float l_bl = tile.l[m + kTw - 1];
  float l_br = tile.l[m + kTw + 1];
  float l_m = tile.l[m];

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
  Rgb ra = mean2(tile_bilinear(tl, img, xf + dir_x * k0, yf + dir_y * k0),
                 tile_bilinear(tl, img, xf + dir_x * k1, yf + dir_y * k1));
  Rgb rb = mean2(tile_bilinear(tl, img, xf + dir_x * -0.5f, yf + dir_y * -0.5f),
                 tile_bilinear(tl, img, xf + dir_x * 0.5f, yf + dir_y * 0.5f));
  Rgb res = mean2(ra, rb);
  float l_res = luma(res);
  Rgb o = (l_res < l_min || l_res > l_max) ? ra : res;
  const long long i = (long long)y * img.w + x;
  out[3 * i + 0] = o.r;
  out[3 * i + 1] = o.g;
  out[3 * i + 2] = o.b;
}

}  // namespace

// image, out: [h,w,3] f32, row-major; halo_lo, halo_hi: the halo the caller
// counts on (fxaa.py's HALO), which must be the kernel's.
extern "C" int rt_fxaa(const void* image, int h, int w, int halo_lo, int halo_hi, void* out,
                       void* stream) {
  if (halo_lo != kHaloLo || halo_hi != kHaloHi) return (int)cudaErrorInvalidValue;
  const Image img{(const float*)image, h, w};
  const dim3 grid((unsigned)((w + kTileW - 1) / kTileW), (unsigned)((h + kTileH - 1) / kTileH));
  tile_kernel<<<grid, dim3(kTileW, kTileH), 0, (cudaStream_t)stream>>>(img, (float*)out);
  return (int)cudaGetLastError();
}
