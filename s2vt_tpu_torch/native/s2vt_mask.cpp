// s2vt_mask: RLE mask operations for the port's pycocotools surface
// (s2vt_tpu_torch/utils/mask.py, s2vt_tpu_torch/cocotools/). The same
// source as native/s2vt_mask.cpp of the JAX package; the port keeps its own
// copy. Built by s2vt_tpu_torch/utils/native_build.py with the same g++
// flags as the JAX package's build (-O3 -std=c++17 -shared -fPIC -pthread,
// no -ffast-math), so poly_to_mask, rle_iou and bb_iou give the same
// doubles; tests/test_torch_mask_ops.py holds every function to the JAX
// package's bit for bit. Not used on the caption path.
//
// RLE convention (COCO): counts alternate runs of 0s and 1s in
// COLUMN-MAJOR (Fortran) order, starting with zeros.
//
// C ABI (ctypes):
//   rle_encode(mask[h*w] col-major uint8, h, w, out_counts, max_n) -> n
//   rle_decode(counts, n, h, w, out_mask) -> 0/-1
//   rle_area(counts, n) -> area
//   rle_merge(a, na, b, nb, intersect, out, max_n) -> n
//   rle_iou(dt_counts.., gt_counts.., iscrowd) -> double
//   rle_to_bbox(counts, n, h, w, out_bbox[4])
//   bb_iou(dt[4], gt[4], iscrowd) -> double
//   rle_to_string(counts, n, out, max_len) -> bytes written, -1 on overflow
//   rle_from_string(s, len, out_counts, max_n) -> n, -1 if invalid
//   poly_to_mask(xy[2*npts], npts, h, w, out_mask[h*w] row-major)

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Encode a column-major binary mask into RLE counts. Returns the number of
// counts written, or -1 if max_n is too small.
long rle_encode(const uint8_t* mask, long h, long w, uint32_t* out,
                long max_n) {
  long n = 0;
  long total = h * w;
  uint8_t prev = 0;
  uint32_t run = 0;
  for (long i = 0; i < total; ++i) {
    uint8_t v = mask[i] ? 1 : 0;
    if (v != prev) {
      if (n >= max_n) return -1;
      out[n++] = run;
      run = 0;
      prev = v;
    }
    run++;
  }
  if (n >= max_n) return -1;
  out[n++] = run;
  return n;
}

int rle_decode(const uint32_t* counts, long n, long h, long w,
               uint8_t* out) {
  long total = h * w;
  long pos = 0;
  uint8_t v = 0;
  for (long i = 0; i < n; ++i) {
    uint32_t run = counts[i];
    if (pos + static_cast<long>(run) > total) return -1;
    for (uint32_t k = 0; k < run; ++k) out[pos++] = v;
    v = 1 - v;
  }
  return pos == total ? 0 : -1;
}

long rle_area(const uint32_t* counts, long n) {
  long a = 0;
  for (long i = 1; i < n; i += 2) a += counts[i];
  return a;
}

// Merge two RLEs (union or intersection). Classic two-pointer sweep over
// run boundaries.
long rle_merge(const uint32_t* a, long na, const uint32_t* b, long nb,
               int intersect, uint32_t* out, long max_n) {
  long ia = 0, ib = 0, n = 0;
  long ca = na > 0 ? static_cast<long>(a[0]) : 0;
  long cb = nb > 0 ? static_cast<long>(b[0]) : 0;
  uint8_t va = 0, vb = 0;
  uint8_t vout_prev = 0;
  long run = 0;
  bool first = true;
  while (ia < na || ib < nb) {
    while (ia < na && ca == 0) {  // advance a
      ia++;
      va = 1 - va;
      if (ia < na) ca = a[ia];
    }
    while (ib < nb && cb == 0) {
      ib++;
      vb = 1 - vb;
      if (ib < nb) cb = b[ib];
    }
    if (ia >= na && ib >= nb) break;
    long step;
    if (ia >= na) step = cb;
    else if (ib >= nb) step = ca;
    else step = std::min(ca, cb);
    if (step <= 0) break;
    uint8_t v = intersect ? (va & vb) : (va | vb);
    if (first) {
      if (v == 1) {  // leading zero run of length 0
        if (n >= max_n) return -1;
        out[n++] = 0;
        vout_prev = 1;
      }
      first = false;
      run = step;
    } else if (v == vout_prev) {
      run += step;
    } else {
      if (n >= max_n) return -1;
      out[n++] = static_cast<uint32_t>(run);
      run = step;
      vout_prev = v;
    }
    ca -= step;
    cb -= step;
  }
  if (run > 0 || n == 0) {
    if (n >= max_n) return -1;
    out[n++] = static_cast<uint32_t>(run);
  }
  return n;
}

double rle_iou(const uint32_t* dt, long ndt, const uint32_t* gt, long ngt,
               int iscrowd) {
  std::vector<uint32_t> tmp(ndt + ngt + 2);
  long ni = rle_merge(dt, ndt, gt, ngt, 1, tmp.data(),
                      static_cast<long>(tmp.size()));
  if (ni < 0) return -1.0;
  double inter = static_cast<double>(rle_area(tmp.data(), ni));
  double a_dt = static_cast<double>(rle_area(dt, ndt));
  double a_gt = static_cast<double>(rle_area(gt, ngt));
  double denom = iscrowd ? a_dt : (a_dt + a_gt - inter);
  return denom > 0 ? inter / denom : 0.0;
}

// Tight bbox [x, y, w, h] of an RLE over an h x w canvas (column-major).
void rle_to_bbox(const uint32_t* counts, long n, long h, long w,
                 double* bbox) {
  long xmin = w, xmax = -1, ymin = h, ymax = -1;
  long pos = 0;
  uint8_t v = 0;
  for (long i = 0; i < n; ++i) {
    long run = counts[i];
    if (v) {
      long start = pos, end = pos + run - 1;
      long x0 = start / h, y0 = start % h;
      long x1 = end / h, y1 = end % h;
      xmin = std::min(xmin, x0);
      xmax = std::max(xmax, x1);
      if (x0 == x1) {
        ymin = std::min(ymin, y0);
        ymax = std::max(ymax, y1);
      } else {  // run spans column boundary -> touches full height
        ymin = 0;
        ymax = h - 1;
      }
    }
    pos += run;
    v = 1 - v;
  }
  if (xmax < 0) {
    bbox[0] = bbox[1] = bbox[2] = bbox[3] = 0.0;
    return;
  }
  bbox[0] = static_cast<double>(xmin);
  bbox[1] = static_cast<double>(ymin);
  bbox[2] = static_cast<double>(xmax - xmin + 1);
  bbox[3] = static_cast<double>(ymax - ymin + 1);
}

double bb_iou(const double* dt, const double* gt, int iscrowd) {
  double a_dt = dt[2] * dt[3], a_gt = gt[2] * gt[3];
  double x0 = std::max(dt[0], gt[0]), y0 = std::max(dt[1], gt[1]);
  double x1 = std::min(dt[0] + dt[2], gt[0] + gt[2]);
  double y1 = std::min(dt[1] + dt[3], gt[1] + gt[3]);
  double inter = std::max(0.0, x1 - x0) * std::max(0.0, y1 - y0);
  double denom = iscrowd ? a_dt : (a_dt + a_gt - inter);
  return denom > 0 ? inter / denom : 0.0;
}

}  // extern "C"

extern "C" {

// COCO compressed RLE string (the pycocotools rleToString/rleFrString
// LEB128 variant with delta coding from the second-previous count).
long rle_to_string(const uint32_t* counts, long n, char* out, long max_len) {
  long p = 0;
  for (long i = 0; i < n; ++i) {
    long x = static_cast<long>(counts[i]);
    if (i > 2) x -= static_cast<long>(counts[i - 2]);
    bool more = true;
    while (more) {
      char c = x & 0x1f;
      x >>= 5;
      more = (c & 0x10) ? x != -1 : x != 0;
      if (more) c |= 0x20;
      c += 48;
      if (p >= max_len) return -1;
      out[p++] = c;
    }
  }
  return p;
}

long rle_from_string(const char* s, long len, uint32_t* out, long max_n) {
  long p = 0, n = 0;
  while (p < len) {
    long x = 0;
    int k = 0;
    bool more = true;
    while (more) {
      if (p >= len || k >= 12) return -1;  // k*5 >= 64 would be UB
      char c = s[p] - 48;
      x |= static_cast<long>(c & 0x1f) << (5 * k);
      more = (c & 0x20) != 0;
      p++;
      k++;
      if (!more && (c & 0x10)) x |= -1L << (5 * k);
    }
    if (n > 2) x += static_cast<long>(out[n - 2]);
    if (n >= max_n) return -1;
    out[n++] = static_cast<uint32_t>(x);
  }
  return n;
}

// Rasterize a polygon (xy pairs, pycocotools convention) to a row-major
// mask via even-odd scanline fill; caller encodes to RLE.
void poly_to_mask(const double* xy, long npts, long h, long w, uint8_t* out) {
  for (long y = 0; y < h; ++y) {
    double yc = y + 0.5;
    // collect x-crossings of the scanline with polygon edges
    std::vector<double> xs;
    for (long i = 0; i < npts; ++i) {
      long j = (i + 1) % npts;
      double x0 = xy[2 * i], y0 = xy[2 * i + 1];
      double x1 = xy[2 * j], y1 = xy[2 * j + 1];
      if ((y0 <= yc && y1 > yc) || (y1 <= yc && y0 > yc)) {
        xs.push_back(x0 + (yc - y0) * (x1 - x0) / (y1 - y0));
      }
    }
    std::sort(xs.begin(), xs.end());
    for (size_t k = 0; k + 1 < xs.size(); k += 2) {
      long xa = static_cast<long>(std::max(0.0, std::ceil(xs[k] - 0.5)));
      long xb = static_cast<long>(
          std::min(static_cast<double>(w - 1), std::floor(xs[k + 1] - 0.5)));
      for (long x = xa; x <= xb; ++x) out[y * w + x] = 1;
    }
  }
}

}  // extern "C"
