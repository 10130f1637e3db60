// tepose_native: host-side native kernels for the streaming pipeline.
//
// Replaces the reference's external native dependencies on the hot host path:
//   * pyrender/EGL offscreen mesh rendering (ref: lib/utils/renderer.py) ->
//     a z-buffered smooth-shaded software rasterizer (three directional
//     lights + ambient, per-pixel interpolated vertex normals) with
//     weak-perspective projection and alpha compositing over the frame.
//   * OpenCV warpAffine bbox crops (ref: lib/data_utils/_img_utils.py:88-101)
//     -> a multithreaded bilinear affine crop + ImageNet normalisation that
//     writes the (3, H, W) float32 tensor the backbone consumes.
//
// Built as a plain shared library (no pybind11; see tepose_tpu_torch/native/
// __init__.py for the ctypes bindings and the build at first use). A copy of
// tepose_tpu/native/tepose_native.cpp; tests/test_torch_host.py holds the
// two libraries' outputs equal.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Rasterizer
// ---------------------------------------------------------------------------

// Render a triangle mesh over an RGB uint8 image in place.
//  verts:  (n_verts, 3) float32, SMPL/world coords (y up, z toward viewer)
//  faces:  (n_faces, 3) int32 vertex indices
//  cam:    (4,) float32 weak-perspective (sx, sy, tx, ty) — pixel mapping
//          px = (1 + sx*(x+tx)) * w/2, py = (1 + sy*(-y+ty)) * h/2
//          (the y flip mirrors the reference's 180-degree mesh rotation,
//           ref: renderer.py:72-79)
//  image:  (h, w, 3) uint8, modified in place
//  color:  (3,) float32 in [0,1]
//  alpha:  mesh opacity
// Lighting model (ref: renderer.py:84-100): pyrender scene with ambient
// (0.3,0.3,0.3), emissive 0.1, roughness-1/metallic-0 material (pure
// Lambert) and THREE DirectionalLights of intensity 0.8 placed at
// [0,-1,1], [0,1,1], [1,1,2] with identity node rotation. pyrender
// directional lights take their direction from the node ROTATION (-z
// axis), not the translation, so all three of the reference's lights
// shine along the camera axis; we model each with its intended placement
// direction instead (normalised toward-the-light vectors, mapped through
// the 180-degree x-rotation the reference applies to the mesh so they sit
// on the viewer's side), which reproduces pyrender's soft top/side fill
// while actually giving the mesh three distinct light directions.
// Smooth (per-pixel interpolated vertex normal) shading matches the
// reference material's smooth=True; flat shading before r4 faceted it.
static const float kLights[3][3] = {
    {0.f, 1.f, 1.f}, {0.f, -1.f, 1.f}, {1.f, -1.f, 2.f}};
static const float kLightIntensity = 0.8f / 3.14159265f;  // Lambert BRDF
static const float kAmbient = 0.3f, kEmissive = 0.1f;

static inline float shade_normal(float nx, float ny, float nz) {
  const float nn = std::sqrt(nx * nx + ny * ny + nz * nz) + 1e-12f;
  float s = kAmbient + kEmissive;
  for (int j = 0; j < 3; ++j) {
    const float lx = kLights[j][0], ly = kLights[j][1], lz = kLights[j][2];
    const float ln = std::sqrt(lx * lx + ly * ly + lz * lz);
    float d = (nx * lx + ny * ly + nz * lz) / (nn * ln);
    if (d < 0) d = -d;  // double-sided (synthetic meshes may flip winding)
    s += kLightIntensity * d;
  }
  return std::min(1.f, s);
}

void render_mesh(const float* verts, int n_verts, const int32_t* faces,
                 int n_faces, const float* cam, uint8_t* image, int h, int w,
                 const float* color, float alpha) {
  std::vector<float> px(n_verts), py(n_verts), pz(n_verts);
  const float sx = cam[0], sy = cam[1], tx = cam[2], ty = cam[3];
  // screen bbox of the whole mesh: the z/shade working buffers and the
  // composite pass below are clipped to it. Full-frame buffers cost a
  // FIXED ~12 ms per 1080p call (two 2-Mpixel clears + a 2-Mpixel
  // composite scan) — 4x the actual triangle work for a typical
  // demo-sized person (measured, BENCH_NOTES.md render stage).
  float mxmin = 1e30f, mxmax = -1e30f, mymin = 1e30f, mymax = -1e30f;
  for (int i = 0; i < n_verts; ++i) {
    const float x = verts[3 * i], y = verts[3 * i + 1], z = verts[3 * i + 2];
    px[i] = (1.f + sx * (x + tx)) * 0.5f * w;
    py[i] = (1.f + sy * (-y + ty)) * 0.5f * h;
    pz[i] = -z;  // camera looks along -z after the flip; smaller = closer
    if (std::isfinite(px[i]) && std::isfinite(py[i])) {
      mxmin = std::min(mxmin, px[i]);
      mxmax = std::max(mxmax, px[i]);
      mymin = std::min(mymin, py[i]);
      mymax = std::max(mymax, py[i]);
    }
  }
  const int bx0 = std::max(0, (int)std::floor(mxmin));
  const int bx1 = std::min(w - 1, (int)std::ceil(mxmax));
  const int by0 = std::max(0, (int)std::floor(mymin));
  const int by1 = std::min(h - 1, (int)std::ceil(mymax));
  if (bx0 > bx1 || by0 > by1) return;  // fully off-frame
  const int bw = bx1 - bx0 + 1, bh = by1 - by0 + 1;

  // area-weighted vertex normals (world coords) for smooth shading
  std::vector<float> vn(static_cast<size_t>(n_verts) * 3, 0.f);
  for (int f = 0; f < n_faces; ++f) {
    const int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    const float ux = verts[3 * b] - verts[3 * a];
    const float uy = verts[3 * b + 1] - verts[3 * a + 1];
    const float uz = verts[3 * b + 2] - verts[3 * a + 2];
    const float vx = verts[3 * c] - verts[3 * a];
    const float vy = verts[3 * c + 1] - verts[3 * a + 1];
    const float vz = verts[3 * c + 2] - verts[3 * a + 2];
    const float nx = uy * vz - uz * vy;
    const float ny = uz * vx - ux * vz;
    const float nz = ux * vy - uy * vx;
    for (int k : {a, b, c}) {
      vn[3 * k] += nx;
      vn[3 * k + 1] += ny;
      vn[3 * k + 2] += nz;
    }
  }

  // bbox-local working buffers (indexed (y-by0)*bw + (x-bx0)); every
  // triangle's clipped pixel range lies inside the mesh bbox by
  // construction, so the raster loop below never indexes outside them
  std::vector<float> zbuf(static_cast<size_t>(bh) * bw, 1e30f);
  std::vector<float> shade(static_cast<size_t>(bh) * bw, -1.f);

  for (int f = 0; f < n_faces; ++f) {
    const int a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
    const float x0 = px[a], y0 = py[a], z0 = pz[a];
    const float x1 = px[b], y1 = py[b], z1 = pz[b];
    const float x2 = px[c], y2 = py[c], z2 = pz[c];

    // clamp to the mesh bbox, not the frame: keeps the bbox-local buffer
    // indexing in range even for degenerate/non-finite vertex coords
    const int xmin = std::max(bx0, (int)std::floor(std::min({x0, x1, x2})));
    const int xmax = std::min(bx1, (int)std::ceil(std::max({x0, x1, x2})));
    const int ymin = std::max(by0, (int)std::floor(std::min({y0, y1, y2})));
    const int ymax = std::min(by1, (int)std::ceil(std::max({y0, y1, y2})));
    if (xmin > xmax || ymin > ymax) continue;

    const float denom = (y1 - y2) * (x0 - x2) + (x2 - x1) * (y0 - y2);
    if (std::fabs(denom) < 1e-12f) continue;
    const float inv_denom = 1.f / denom;

    for (int y = ymin; y <= ymax; ++y) {
      for (int x = xmin; x <= xmax; ++x) {
        const float w0 =
            ((y1 - y2) * (x - x2) + (x2 - x1) * (y - y2)) * inv_denom;
        const float w1 =
            ((y2 - y0) * (x - x2) + (x0 - x2) * (y - y2)) * inv_denom;
        const float w2 = 1.f - w0 - w1;
        if (w0 < 0 || w1 < 0 || w2 < 0) continue;
        const float z = w0 * z0 + w1 * z1 + w2 * z2;
        const size_t idx = static_cast<size_t>(y - by0) * bw + (x - bx0);
        if (z < zbuf[idx]) {
          zbuf[idx] = z;
          shade[idx] = shade_normal(
              w0 * vn[3 * a] + w1 * vn[3 * b] + w2 * vn[3 * c],
              w0 * vn[3 * a + 1] + w1 * vn[3 * b + 1] + w2 * vn[3 * c + 1],
              w0 * vn[3 * a + 2] + w1 * vn[3 * b + 2] + w2 * vn[3 * c + 2]);
        }
      }
    }
  }

  for (int y = by0; y <= by1; ++y) {
    for (int x = bx0; x <= bx1; ++x) {
      const size_t idx = static_cast<size_t>(y - by0) * bw + (x - bx0);
      if (shade[idx] < 0) continue;
      uint8_t* p = image + 3 * (static_cast<size_t>(y) * w + x);
      for (int ch = 0; ch < 3; ++ch) {
        const float mesh = 255.f * color[ch] * shade[idx];
        const float out = alpha * mesh + (1.f - alpha) * p[ch];
        p[ch] = (uint8_t)std::min(255.f, std::max(0.f, out));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Affine crops
// ---------------------------------------------------------------------------

// Crop-and-normalise a batch of bboxes from one RGB uint8 frame.
//  image:  (h, w, 3) uint8
//  bboxes: (n, 4) float32 — (cx, cy, bw, bh); box is scaled by `scale`
//  out:    (n, 3, out_size, out_size) float32, ImageNet-normalised
static void crop_impl(const uint8_t* image, int h, int w,
                      const float* bboxes, int n, int out_size, float scale,
                      float* out_f32, uint8_t* out_u8) {
  static const float kMean[3] = {0.485f, 0.456f, 0.406f};
  static const float kStd[3] = {0.229f, 0.224f, 0.225f};

  int n_threads = std::min<int>(n, std::thread::hardware_concurrency());
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);

  auto worker = [&]() {
    for (;;) {
      const int i = next.fetch_add(1);
      if (i >= n) return;
      const float cx = bboxes[4 * i], cy = bboxes[4 * i + 1];
      const float bw = bboxes[4 * i + 2] * scale;
      const float bh = bboxes[4 * i + 3] * scale;
      // patch (px, py) -> image coords (matching data.transforms.patch_affine
      // inverted: img = center + (p/out - 0.5) * box)
      const float step_x = bw / out_size, step_y = bh / out_size;
      const float x0 = cx - bw * 0.5f + 0.5f * step_x;
      const float y0 = cy - bh * 0.5f + 0.5f * step_y;
      const size_t base = static_cast<size_t>(i) * 3 * out_size * out_size;
      float* dst = out_f32 ? out_f32 + base : nullptr;
      uint8_t* dst8 = out_u8 ? out_u8 + base : nullptr;
      for (int py = 0; py < out_size; ++py) {
        const float sy_img = y0 + py * step_y;
        for (int pxi = 0; pxi < out_size; ++pxi) {
          const float sx_img = x0 + pxi * step_x;
          float rgb[3] = {0, 0, 0};
          if (sx_img >= 0 && sx_img <= w - 1 && sy_img >= 0 &&
              sy_img <= h - 1) {
            const int ix = (int)sx_img, iy = (int)sy_img;
            const float fx = sx_img - ix, fy = sy_img - iy;
            const int ix1 = std::min(ix + 1, w - 1);
            const int iy1 = std::min(iy + 1, h - 1);
            for (int ch = 0; ch < 3; ++ch) {
              const float v00 = image[(iy * (size_t)w + ix) * 3 + ch];
              const float v01 = image[(iy * (size_t)w + ix1) * 3 + ch];
              const float v10 = image[(iy1 * (size_t)w + ix) * 3 + ch];
              const float v11 = image[(iy1 * (size_t)w + ix1) * 3 + ch];
              rgb[ch] = (1 - fy) * ((1 - fx) * v00 + fx * v01) +
                        fy * ((1 - fx) * v10 + fx * v11);
            }
          }
          for (int ch = 0; ch < 3; ++ch) {
            const size_t o = (ch * (size_t)out_size + py) * out_size + pxi;
            if (dst) dst[o] = (rgb[ch] / 255.f - kMean[ch]) / kStd[ch];
            if (dst8) dst8[o] = (uint8_t)(rgb[ch] + 0.5f);
          }
        }
      }
    }
  };

  std::vector<std::thread> threads;
  for (int t = 0; t < n_threads; ++t) threads.emplace_back(worker);
  for (auto& t : threads) t.join();
}

// Crop-and-normalise a batch of bboxes from one RGB uint8 frame.
//  image:  (h, w, 3) uint8
//  bboxes: (n, 4) float32 — (cx, cy, bw, bh); box is scaled by `scale`
//  out:    (n, 3, out_size, out_size) float32, ImageNet-normalised
void crop_normalize(const uint8_t* image, int h, int w, const float* bboxes,
                    int n, int out_size, float scale, float* out) {
  crop_impl(image, h, w, bboxes, n, out_size, scale, out, nullptr);
}

// Same bilinear crop, raw uint8 output (ImageNet normalisation happens on
// the accelerator — the uint8 form is 4x cheaper to ship over the link).
void crop_u8(const uint8_t* image, int h, int w, const float* bboxes,
             int n, int out_size, float scale, uint8_t* out) {
  crop_impl(image, h, w, bboxes, n, out_size, scale, nullptr, out);
}

}  // extern "C"
