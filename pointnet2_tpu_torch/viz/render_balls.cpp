// Z-buffered sphere-sprite point-cloud rasterizer (host-side, ctypes).
//
// The port's copy of pointnet2_tpu/viz/render_balls.cpp (the reference
// viewer's utils/render_balls_so.cpp capability): splats each point as a
// shaded ball into an RGB canvas with per-pixel depth testing. A host
// renderer, not a device kernel. viz/viewer.py builds it at first use:
//   g++ -O3 -shared -fPIC render_balls.cpp -o _build/librender_balls-<hash>.so
//
// API (extern "C", called from viz/viewer.py via ctypes):
//   render_balls(h, w, image_u8[h*w*3], n,
//                xyz_f32[n*3], color_u8[n*3], radii_f32[n])
// Coordinates are pre-projected: x -> row, y -> col, z -> depth (larger z
// is nearer). Out-of-canvas points are clipped.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

void render_balls(int h, int w, uint8_t *image, int n, const float *xyz,
                  const uint8_t *color, const float *radii) {
  std::vector<float> zbuf(static_cast<size_t>(h) * w,
                          -std::numeric_limits<float>::infinity());
  for (int i = 0; i < n; ++i) {
    const float cx = xyz[i * 3 + 0];
    const float cy = xyz[i * 3 + 1];
    const float cz = xyz[i * 3 + 2];
    const float r = radii[i];
    if (r <= 0) continue;
    const int x0 = static_cast<int>(std::floor(cx - r));
    const int x1 = static_cast<int>(std::ceil(cx + r));
    const int y0 = static_cast<int>(std::floor(cy - r));
    const int y1 = static_cast<int>(std::ceil(cy + r));
    for (int x = x0 <= 0 ? 0 : x0; x <= x1 && x < h; ++x) {
      for (int y = y0 <= 0 ? 0 : y0; y <= y1 && y < w; ++y) {
        const float dx = x - cx, dy = y - cy;
        const float d2 = dx * dx + dy * dy;
        if (d2 > r * r) continue;
        // sphere surface depth + simple Lambertian shade
        const float dz = std::sqrt(r * r - d2);
        const float z = cz + dz;
        const size_t p = static_cast<size_t>(x) * w + y;
        if (z <= zbuf[p]) continue;
        zbuf[p] = z;
        const float shade = 0.35f + 0.65f * (dz / r);
        image[p * 3 + 0] = static_cast<uint8_t>(color[i * 3 + 0] * shade);
        image[p * 3 + 1] = static_cast<uint8_t>(color[i * 3 + 1] * shade);
        image[p * 3 + 2] = static_cast<uint8_t>(color[i * 3 + 2] * shade);
      }
    }
  }
}

}  // extern "C"
