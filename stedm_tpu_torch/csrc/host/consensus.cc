// Multi-annotator consensus kernel (C++ port of the reference's numba kernels,
// reference data/her2/her2_utils.py:87-130).
//
// Per pixel over K annotator values (uint8 codes: 0 BG, 1-4 HER2 grades,
// 5 DCIS/LCIS, 6 hard negative):
//   stage 1: group codes into {0: BG/HN, 1: grades, 2: DCIS} and take
//            ceil(median) over the group ids,
//   stage 2: resolve within the winning group (BG-vs-HN majority / grade median),
// writing the consensus value and its vote strength.
//
// WSI-scale masks are hundreds of megapixels; the numpy reference in
// stedm_tpu_torch/data/prep.py nanmedian's its way through them, this kernel
// streams pixels with a fixed 7-bin histogram (exact median, no sort) and is
// invoked via ctypes from stedm_tpu_torch/native.py.
//
// A copy of native/consensus.cc (the port builds its own host library).

#include <cstdint>
#include <cstddef>

namespace {

// exact median*2 of values mapped through `group` over a 7-bin histogram
inline int median2_from_hist(const int* hist, int bins, int count) {
  // returns 2*median so .5 medians stay integral; ceil(median) == (m2 + 1) / 2
  const int lo_rank = (count - 1) / 2;  // 0-based lower middle
  const int hi_rank = count / 2;        // 0-based upper middle
  int lo = -1, hi = -1, seen = 0;
  for (int b = 0; b < bins; ++b) {
    seen += hist[b];
    if (lo < 0 && seen > lo_rank) lo = b;
    if (hi < 0 && seen > hi_rank) { hi = b; break; }
  }
  return lo + hi;
}

}  // namespace

extern "C" {

// stack: [k, h*w] row-major (annotator-major); value/strength: [h*w]
void stedm_consensus(const uint8_t* stack, int64_t k, int64_t hw,
                     uint8_t* value, uint8_t* strength) {
  for (int64_t px = 0; px < hw; ++px) {
    int code_hist[7] = {0};
    for (int64_t a = 0; a < k; ++a) {
      uint8_t v = stack[a * hw + px];
      if (v > 6) v = 0;  // out-of-range codes count as background
      ++code_hist[v];
    }
    // stage 1: group histogram {BG/HN, grades, DCIS}
    int grade_votes = code_hist[1] + code_hist[2] + code_hist[3] + code_hist[4];
    int group_hist[3] = {code_hist[0] + code_hist[6], grade_votes, code_hist[5]};
    int m2 = median2_from_hist(group_hist, 3, static_cast<int>(k));
    int first = (m2 + 1) / 2;  // ceil of the true median

    if (first == 0) {
      int bg = code_hist[0], hn = code_hist[6];
      value[px] = (hn >= bg) ? 6 : 0;
      strength[px] = static_cast<uint8_t>(bg + hn);
    } else if (first == 1) {
      if (grade_votes == 0) {
        // degenerate BG/DCIS tie with no grade votes: match the vectorized
        // python path (value 0, strength 0)
        value[px] = 0;
        strength[px] = 0;
        continue;
      }
      int grade_hist[5] = {0, code_hist[1], code_hist[2], code_hist[3],
                           code_hist[4]};
      int gm2 = median2_from_hist(grade_hist + 1, 4, grade_votes);
      int v = (gm2 + 1) / 2 + 1;  // +1: histogram bins start at grade 1
      value[px] = static_cast<uint8_t>(v);
      strength[px] = static_cast<uint8_t>(code_hist[v]);
    } else {
      value[px] = 5;
      strength[px] = static_cast<uint8_t>(code_hist[5]);
    }
  }
}

// Overlap-aware patch extraction (the PatchHandlerMS.get hot loop,
// reference utils/patch_handler_ms.py:24-48): crop [y_s:y_e, x_s:x_e] from an
// image of shape [h, w, c], padding out-of-bounds regions with `fill`.
void stedm_extract_patch(const uint8_t* image, int64_t h, int64_t w, int64_t c,
                         int64_t y_s, int64_t x_s, int64_t patch,
                         uint8_t fill, uint8_t* out) {
  for (int64_t y = 0; y < patch; ++y) {
    const int64_t sy = y_s + y;
    uint8_t* row = out + y * patch * c;
    if (sy < 0 || sy >= h) {
      for (int64_t i = 0; i < patch * c; ++i) row[i] = fill;
      continue;
    }
    for (int64_t x = 0; x < patch; ++x) {
      const int64_t sx = x_s + x;
      uint8_t* px = row + x * c;
      if (sx < 0 || sx >= w) {
        for (int64_t ch = 0; ch < c; ++ch) px[ch] = fill;
      } else {
        const uint8_t* src = image + (sy * w + sx) * c;
        for (int64_t ch = 0; ch < c; ++ch) px[ch] = src[ch];
      }
    }
  }
}

// 2x2x... block-mean downscale for uint8 imagery (the wsi_sample fallback path,
// reference her2_utils.py:204-208): factor f in both spatial dims, channels kept.
void stedm_downscale_mean(const uint8_t* image, int64_t h, int64_t w, int64_t c,
                          int64_t f, uint8_t* out) {
  const int64_t oh = h / f, ow = w / f;
  for (int64_t y = 0; y < oh; ++y) {
    for (int64_t x = 0; x < ow; ++x) {
      for (int64_t ch = 0; ch < c; ++ch) {
        int64_t acc = 0;
        for (int64_t dy = 0; dy < f; ++dy) {
          const uint8_t* row = image + ((y * f + dy) * w + x * f) * c + ch;
          for (int64_t dx = 0; dx < f; ++dx) acc += row[dx * c];
        }
        out[(y * ow + x) * c + ch] =
            static_cast<uint8_t>(acc / (f * f));
      }
    }
  }
}

}  // extern "C"
