// Box arithmetic shared by K4 (assoc.cu) and K6 (nms.cu), written to give
// the bits the port's torch functions give.
//
// Each helper is one torch operation and rounds as it does: the sources
// that include this header build with --fmad=false, so no multiply and
// add fuse; sqrtf and '/' stay correctly rounded (no fast-math).
// torch.minimum, torch.maximum and torch.clamp propagate NaN where CUDA's
// fminf / fmaxf return the other operand, hence nan_min / nan_max /
// clamp_min. The sign of a zero never reaches a result: every value below
// is only compared, and a division happens only by a positive union.

#pragma once

#include <math.h>

namespace rvt {

__device__ __forceinline__ float nan_min(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fminf(a, b);
}

__device__ __forceinline__ float nan_max(float a, float b) {
  return (isnan(a) || isnan(b)) ? __int_as_float(0x7fffffff) : fmaxf(a, b);
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

// clamp(x2 - x1, min=0) * clamp(y2 - y1, min=0)
__device__ __forceinline__ float box_area(float x1, float y1, float x2,
                                          float y2) {
  return clamp_min(x2 - x1, 0.0f) * clamp_min(y2 - y1, 0.0f);
}

// IoU of box a against box b in the order of track/sort.py::iou_matrix
// and ops/nms.py::iou_matrix_xyxy (the two compute the same thing):
// inter = clamp(min(x2) - max(x1), 0) * clamp(min(y2) - max(y1), 0),
// union = (area_a + area_b) - inter, inter / union where union > 0,
// else 0. A NaN coordinate gives a NaN union, hence 0.
__device__ __forceinline__ float box_iou(float ax1, float ay1, float ax2,
                                         float ay2, float area_a, float bx1,
                                         float by1, float bx2, float by2,
                                         float area_b) {
  const float iw = clamp_min(nan_min(ax2, bx2) - nan_max(ax1, bx1), 0.0f);
  const float ih = clamp_min(nan_min(ay2, by2) - nan_max(ay1, by1), 0.0f);
  const float inter = iw * ih;
  const float uni = area_a + area_b - inter;
  return uni > 0.0f ? inter / uni : 0.0f;
}

}  // namespace rvt
