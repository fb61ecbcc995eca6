// plotweave native raster helpers: OpenCV-exact drawing, minimum enclosing
// circle, and PNG row unfiltering.
//
// The drawing routines reproduce OpenCV's imgproc/drawing.cpp integer
// rasterizers (thin 8-connected lines, the 16.16 fixed-point thick-line quad
// plus round caps, the anti-aliased line with its filter tables, the convex
// polygon scan fill, Bresenham circles and the polygonal ellipse), so the
// previews, dedup canvases and stamp tables built here are pixel-identical to
// what the reference's cv2 calls draw.  The parity tests in
// tests/test_raster_native.py pin every primitive against cv2.
//
// Images are uint8, `cn` interleaved channels (1, 3 or 4) per pixel, rows
// `step` bytes apart (so a numpy row-slice view can be drawn into in place).

#include <cstdint>
#include <cstring>
#include <cmath>
#include <vector>
#include <algorithm>

namespace {

const int XY_SHIFT = 16;
const int64_t XY_ONE = (int64_t)1 << XY_SHIFT;
const int LT_AA = 16;  // cv2.LINE_AA

struct Img {
    uint8_t* data;
    int h, w, cn;
    int64_t step;  // bytes per row
    inline uint8_t* px(int x, int y) const {
        return data + (int64_t)y * step + (int64_t)x * cn;
    }
};

struct P2 { int64_t x, y; };

inline void put(const Img& im, int x, int y, const uint8_t* c) {
    uint8_t* p = im.px(x, y);
    for (int k = 0; k < im.cn; ++k) p[k] = c[k];
}

inline void hline(const Img& im, int y, int x1, int x2, const uint8_t* c) {
    uint8_t* p = im.px(x1, y);
    int n = x2 - x1 + 1;
    if (n <= 0) return;
    if (im.cn == 1) {
        std::memset(p, c[0], (size_t)n);
    } else if (im.cn == 3) {
        for (int i = 0; i < n; ++i, p += 3) { p[0] = c[0]; p[1] = c[1]; p[2] = c[2]; }
    } else {
        for (int i = 0; i < n; ++i, p += im.cn)
            for (int k = 0; k < im.cn; ++k) p[k] = c[k];
    }
}

inline int cv_round(double v) { return (int)std::nearbyint(v); }

// Cohen-Sutherland clip to [0, w-1] x [0, h-1] (OpenCV clipLine, int64).
bool clip_line(int64_t w, int64_t h, int64_t& x1, int64_t& y1, int64_t& x2, int64_t& y2) {
    if (w <= 0 || h <= 0) return false;
    int64_t right = w - 1, bottom = h - 1;
    int c1 = (x1 < 0) + (x1 > right) * 2 + (y1 < 0) * 4 + (y1 > bottom) * 8;
    int c2 = (x2 < 0) + (x2 > right) * 2 + (y2 < 0) * 4 + (y2 > bottom) * 8;
    if ((c1 & c2) == 0 && (c1 | c2) != 0) {
        int64_t a;
        if (c1 & 12) {
            a = c1 < 8 ? 0 : bottom;
            x1 += (int64_t)((double)(a - y1) * (x2 - x1) / (y2 - y1));
            y1 = a;
            c1 = (x1 < 0) + (x1 > right) * 2;
        }
        if (c2 & 12) {
            a = c2 < 8 ? 0 : bottom;
            x2 += (int64_t)((double)(a - y2) * (x2 - x1) / (y2 - y1));
            y2 = a;
            c2 = (x2 < 0) + (x2 > right) * 2;
        }
        if ((c1 & c2) == 0 && (c1 | c2) != 0) {
            if (c1) {
                a = c1 == 1 ? 0 : right;
                y1 += (int64_t)((double)(a - x1) * (y2 - y1) / (x2 - x1));
                x1 = a;
                c1 = 0;
            }
            if (c2) {
                a = c2 == 1 ? 0 : right;
                y2 += (int64_t)((double)(a - x2) * (y2 - y1) / (x2 - x1));
                x2 = a;
                c2 = 0;
            }
        }
    }
    return (c1 | c2) == 0;
}

// Thin 8-connected Bresenham line between integer points (OpenCV Line via
// LineIterator, left-to-right).
void line8(const Img& im, int64_t x1, int64_t y1, int64_t x2, int64_t y2, const uint8_t* c) {
    if ((uint64_t)x1 >= (uint64_t)im.w || (uint64_t)x2 >= (uint64_t)im.w ||
        (uint64_t)y1 >= (uint64_t)im.h || (uint64_t)y2 >= (uint64_t)im.h) {
        if (!clip_line(im.w, im.h, x1, y1, x2, y2)) return;
    }
    int64_t dx = x2 - x1, dy = y2 - y1;
    if (dx < 0) {
        dx = -dx; dy = -dy;
        std::swap(x1, x2); std::swap(y1, y2);
    }
    int sy = 1;
    if (dy < 0) { dy = -dy; sy = -1; }
    bool vert = dy > dx;
    int64_t major = vert ? dy : dx, minor = vert ? dx : dy;
    int64_t err = major - (minor + minor);
    int64_t plus = major + major, minus = -(minor + minor);
    int64_t x = x1, y = y1;
    for (int64_t i = 0; i <= major; ++i) {
        put(im, (int)x, (int)y, c);
        bool m = err < 0;
        err += minus + (m ? plus : 0);
        if (vert) { y += sy; if (m) x += 1; }
        else { x += 1; if (m) y += sy; }
    }
}

// Thin line between 16.16 fixed-point points (OpenCV Line2).
void line2(const Img& im, P2 p1, P2 p2, const uint8_t* c) {
    if (!clip_line((int64_t)im.w << XY_SHIFT, (int64_t)im.h << XY_SHIFT, p1.x, p1.y, p2.x, p2.y))
        return;
    int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
    int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
    int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
    int64_t x_step, y_step;
    int ecount;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        if (j) std::swap(p1, p2);
        x_step = XY_ONE;
        y_step = (dy * XY_ONE) / (ax | 1);
        ecount = (int)((p2.x - p1.x) >> XY_SHIFT);
    } else {
        dx = (dx ^ i) - i;
        if (i) std::swap(p1, p2);
        x_step = (dx * XY_ONE) / (ay | 1);
        y_step = XY_ONE;
        ecount = (int)((p2.y - p1.y) >> XY_SHIFT);
    }
    p1.x += XY_ONE >> 1;
    p1.y += XY_ONE >> 1;
    auto put_clip = [&](int64_t x, int64_t y) {
        if (0 <= x && x < im.w && 0 <= y && y < im.h) put(im, (int)x, (int)y, c);
    };
    put_clip((p2.x + (XY_ONE >> 1)) >> XY_SHIFT, (p2.y + (XY_ONE >> 1)) >> XY_SHIFT);
    if (ax > ay) {
        p1.x >>= XY_SHIFT;
        for (; ecount >= 0; --ecount) {
            put_clip(p1.x, p1.y >> XY_SHIFT);
            p1.x++;
            p1.y += y_step;
        }
    } else {
        p1.y >>= XY_SHIFT;
        for (; ecount >= 0; --ecount) {
            put_clip(p1.x >> XY_SHIFT, p1.y);
            p1.x += x_step;
            p1.y++;
        }
    }
}

const int SlopeCorrTable[] = {
    181, 181, 181, 182, 182, 183, 184, 185, 187, 188, 190, 192, 194, 196, 198, 201,
    203, 206, 209, 211, 214, 218, 221, 224, 227, 231, 235, 238, 242, 246, 250, 254};

const int FilterTable[] = {
    168, 177, 185, 194, 202, 210, 218, 224, 231, 236, 241, 246, 249, 252, 254, 254,
    254, 254, 252, 249, 246, 241, 236, 231, 224, 218, 210, 202, 194, 185, 177, 168,
    158, 149, 140, 131, 122, 114, 105, 97, 89, 82, 75, 68, 62, 56, 50, 45,
    40, 36, 32, 28, 25, 22, 19, 16, 14, 12, 11, 9, 8, 7, 5, 5};

inline void blend(const Img& im, int x, int y, const uint8_t* c, int a) {
    uint8_t* p = im.px(x, y);
    for (int k = 0; k < im.cn; ++k) {
        int v = p[k];
        v += ((c[k] - v) * a + 127) >> 8;
        v += ((c[k] - v) * a + 127) >> 8;
        p[k] = (uint8_t)v;
    }
}

// Anti-aliased line between 16.16 fixed-point points (OpenCV LineAA).
void line_aa(const Img& im, P2 p1, P2 p2, const uint8_t* c) {
    if (!clip_line((int64_t)im.w << XY_SHIFT, (int64_t)im.h << XY_SHIFT, p1.x, p1.y, p2.x, p2.y))
        return;
    int64_t dx = p2.x - p1.x, dy = p2.y - p1.y;
    int64_t j = dx < 0 ? -1 : 0, ax = (dx ^ j) - j;
    int64_t i = dy < 0 ? -1 : 0, ay = (dy ^ i) - i;
    int64_t x_step, y_step;
    int ecount, scount = 0, slope;
    if (ax > ay) {
        dy = (dy ^ j) - j;
        if (j) std::swap(p1, p2);
        x_step = XY_ONE;
        y_step = (dy * XY_ONE) / (ax | 1);
        p2.x += XY_ONE;
        ecount = (int)((p2.x >> XY_SHIFT) - (p1.x >> XY_SHIFT));
        j = -(p1.x & (XY_ONE - 1));
        p1.y += ((y_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (int)((y_step >> (XY_SHIFT - 5)) & 0x3f);
        slope ^= (y_step < 0 ? 0x3f : 0);
        i = (p1.x >> (XY_SHIFT - 7)) & 0x78;
        j = (p2.x >> (XY_SHIFT - 7)) & 0x78;
    } else {
        dx = (dx ^ i) - i;
        if (i) std::swap(p1, p2);
        x_step = (dx * XY_ONE) / (ay | 1);
        y_step = XY_ONE;
        p2.y += XY_ONE;
        ecount = (int)((p2.y >> XY_SHIFT) - (p1.y >> XY_SHIFT));
        j = -(p1.y & (XY_ONE - 1));
        p1.x += ((x_step * j) >> XY_SHIFT) + (XY_ONE >> 1);
        slope = (int)((x_step >> (XY_SHIFT - 5)) & 0x3f);
        slope ^= (x_step < 0 ? 0x3f : 0);
        i = (p1.y >> (XY_SHIFT - 7)) & 0x78;
        j = (p2.y >> (XY_SHIFT - 7)) & 0x78;
    }
    slope = (slope & 0x20) ? 0x100 : SlopeCorrTable[slope];
    int ep[9];
    {
        int ii = (int)i, jj = (int)j;
        int t0 = slope << 7;
        int t1 = ((0x78 - ii) | 4) * slope;
        int t2 = (jj | 4) * slope;
        ep[0] = 0;
        ep[8] = slope;
        ep[1] = ep[3] = ((((jj - ii) & 0x78) | 4) * slope >> 8) & 0x1ff;
        ep[2] = (t1 >> 8) & 0x1ff;
        ep[4] = ((((jj - ii) + 0x80) | 4) * slope >> 8) & 0x1ff;
        ep[5] = ((t1 + t0) >> 8) & 0x1ff;
        ep[6] = (t2 >> 8) & 0x1ff;
        ep[7] = ((t2 + t0) >> 8) & 0x1ff;
    }
    if (ax > ay) {
        int x = (int)(p1.x >> XY_SHIFT);
        for (; ecount >= 0; x++, p1.y += y_step, scount++, ecount--) {
            if ((unsigned)x >= (unsigned)im.w) continue;
            int y = (int)((p1.y >> XY_SHIFT) - 1);
            int ep_corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                             (((ecount >= 2) + 1) & (ecount | 2))];
            int dist = (int)((p1.y >> (XY_SHIFT - 5)) & 31);
            int a = (ep_corr * FilterTable[dist + 32] >> 8) & 0xff;
            if ((unsigned)y < (unsigned)im.h) blend(im, x, y, c, a);
            a = (ep_corr * FilterTable[dist] >> 8) & 0xff;
            if ((unsigned)(y + 1) < (unsigned)im.h) blend(im, x, y + 1, c, a);
            a = (ep_corr * FilterTable[63 - dist] >> 8) & 0xff;
            if ((unsigned)(y + 2) < (unsigned)im.h) blend(im, x, y + 2, c, a);
        }
    } else {
        int y = (int)(p1.y >> XY_SHIFT);
        for (; ecount >= 0; y++, p1.x += x_step, scount++, ecount--) {
            if ((unsigned)y >= (unsigned)im.h) continue;
            int x = (int)((p1.x >> XY_SHIFT) - 1);
            int ep_corr = ep[(((scount >= 2) + 1) & (scount | 2)) * 3 +
                             (((ecount >= 2) + 1) & (ecount | 2))];
            int dist = (int)((p1.x >> (XY_SHIFT - 5)) & 31);
            int a = (ep_corr * FilterTable[dist + 32] >> 8) & 0xff;
            if ((unsigned)x < (unsigned)im.w) blend(im, x, y, c, a);
            a = (ep_corr * FilterTable[dist] >> 8) & 0xff;
            if ((unsigned)(x + 1) < (unsigned)im.w) blend(im, x + 1, y, c, a);
            a = (ep_corr * FilterTable[63 - dist] >> 8) & 0xff;
            if ((unsigned)(x + 2) < (unsigned)im.w) blend(im, x + 2, y, c, a);
        }
    }
}

// Scan-fill of a convex polygon, outline first (OpenCV FillConvexPoly).
void fill_convex_poly(const Img& im, const P2* v, int npts, const uint8_t* c, int line_type, int shift) {
    struct { int idx, di; int64_t x, dx; int ye; } edge[2];
    int delta = 1 << shift >> 1;
    int i, y, imin = 0;
    int edges = npts;
    int64_t xmin, xmax, ymin, ymax;
    int64_t delta1, delta2;
    if (line_type < LT_AA) delta1 = delta2 = XY_ONE >> 1;
    else delta1 = XY_ONE - 1, delta2 = 0;

    P2 p0 = v[npts - 1];
    p0.x <<= XY_SHIFT - shift;
    p0.y <<= XY_SHIFT - shift;
    xmin = xmax = v[0].x;
    ymin = ymax = v[0].y;
    for (i = 0; i < npts; i++) {
        P2 p = v[i];
        if (p.y < ymin) { ymin = p.y; imin = i; }
        ymax = std::max(ymax, p.y);
        xmax = std::max(xmax, p.x);
        xmin = std::min(xmin, p.x);
        p.x <<= XY_SHIFT - shift;
        p.y <<= XY_SHIFT - shift;
        if (line_type <= 8) {
            if (shift == 0)
                line8(im, p0.x >> XY_SHIFT, p0.y >> XY_SHIFT, p.x >> XY_SHIFT, p.y >> XY_SHIFT, c);
            else
                line2(im, p0, p, c);
        } else {
            line_aa(im, p0, p, c);
        }
        p0 = p;
    }
    xmin = (xmin + delta) >> shift;
    xmax = (xmax + delta) >> shift;
    ymin = (ymin + delta) >> shift;
    ymax = (ymax + delta) >> shift;
    if (npts < 3 || (int)xmax < 0 || (int)ymax < 0 || (int)xmin >= im.w || (int)ymin >= im.h)
        return;
    ymax = std::min<int64_t>(ymax, im.h - 1);
    edge[0].idx = edge[1].idx = imin;
    edge[0].ye = edge[1].ye = y = (int)ymin;
    edge[0].di = 1;
    edge[1].di = npts - 1;
    edge[0].x = edge[1].x = -XY_ONE;
    edge[0].dx = edge[1].dx = 0;
    do {
        if (line_type < LT_AA || y < (int)ymax || y == (int)ymin) {
            for (i = 0; i < 2; i++) {
                if (y >= edge[i].ye) {
                    int idx0 = edge[i].idx, di = edge[i].di;
                    int idx = idx0 + di;
                    if (idx >= npts) idx -= npts;
                    int ty = 0;
                    for (; edges-- > 0;) {
                        ty = (int)((v[idx].y + delta) >> shift);
                        if (ty > y) {
                            int64_t xs = v[idx0].x;
                            int64_t xe = v[idx].x;
                            if (shift != XY_SHIFT) {
                                xs <<= XY_SHIFT - shift;
                                xe <<= XY_SHIFT - shift;
                            }
                            edge[i].ye = ty;
                            edge[i].dx = ((xe - xs) * 2 + ((int64_t)ty - y)) / (2 * ((int64_t)ty - y));
                            edge[i].x = xs;
                            edge[i].idx = idx;
                            break;
                        }
                        idx0 = idx;
                        idx += di;
                        if (idx >= npts) idx -= npts;
                    }
                }
            }
        }
        if (edges < 0) break;
        if (y >= 0) {
            int left = 0, right = 1;
            if (edge[0].x > edge[1].x) { left = 1; right = 0; }
            int xx1 = (int)((edge[left].x + delta1) >> XY_SHIFT);
            int xx2 = (int)((edge[right].x + delta2) >> XY_SHIFT);
            if (xx2 >= 0 && xx1 < im.w) {
                if (xx1 < 0) xx1 = 0;
                if (xx2 >= im.w) xx2 = im.w - 1;
                hline(im, y, xx1, xx2, c);
            }
        }
        edge[0].x += edge[0].dx;
        edge[1].x += edge[1].dx;
    } while (++y <= (int)ymax);
}

// Bresenham circle, outline or filled (OpenCV Circle: LINE_8, thickness 1/-1).
void circle_bres(const Img& im, int cx, int cy, int radius, const uint8_t* c, bool fill) {
    int err = 0, dx = radius, dy = 0, plus = 1, minus = (radius << 1) - 1;
    int inside = cx >= radius && cx < im.w - radius && cy >= radius && cy < im.h - radius;
    while (dx >= dy) {
        int y11 = cy - dy, y12 = cy + dy, y21 = cy - dx, y22 = cy + dx;
        int x11 = cx - dx, x12 = cx + dx, x21 = cx - dy, x22 = cx + dy;
        if (inside) {
            if (!fill) {
                put(im, x11, y11, c); put(im, x11, y12, c);
                put(im, x12, y11, c); put(im, x12, y12, c);
                put(im, x21, y21, c); put(im, x21, y22, c);
                put(im, x22, y21, c); put(im, x22, y22, c);
            } else {
                hline(im, y11, x11, x12, c); hline(im, y12, x11, x12, c);
                hline(im, y21, x21, x22, c); hline(im, y22, x21, x22, c);
            }
        } else if (x11 < im.w && x12 >= 0 && y21 < im.h && y22 >= 0) {
            if (fill) {
                x11 = std::max(x11, 0);
                x12 = std::min(x12, im.w - 1);
            }
            for (int yy : {y11, y12}) {
                if ((unsigned)yy < (unsigned)im.h) {
                    if (!fill) {
                        if (x11 >= 0) put(im, x11, yy, c);
                        if (x12 < im.w) put(im, x12, yy, c);
                    } else {
                        hline(im, yy, x11, x12, c);
                    }
                }
            }
            if (x21 < im.w && x22 >= 0) {
                if (fill) {
                    x21 = std::max(x21, 0);
                    x22 = std::min(x22, im.w - 1);
                }
                for (int yy : {y21, y22}) {
                    if ((unsigned)yy < (unsigned)im.h) {
                        if (!fill) {
                            if (x21 >= 0) put(im, x21, yy, c);
                            if (x22 < im.w) put(im, x22, yy, c);
                        } else {
                            hline(im, yy, x21, x22, c);
                        }
                    }
                }
            }
        }
        dy++;
        err += plus;
        plus += 2;
        int mask = (err <= 0) - 1;
        err -= minus & mask;
        dx += mask;
        minus -= mask & 2;
    }
}

float sin_table[451];
bool sin_ready = false;

void init_sin_table() {
    if (sin_ready) return;
    // OpenCV's SinTable: sin of each whole degree 0..450, rounded to 7 digits
    for (int d = 0; d <= 450; ++d)
        sin_table[d] = (float)(std::nearbyint(std::sin(d * M_PI / 180.0) * 1e7) / 1e7);
    sin_ready = true;
}

// Full-circle polygon of an axis-aligned ellipse (OpenCV ellipse2Poly,
// angle 0, arc 0..360) in doubles.
void ellipse2poly(double cx, double cy, double ax, double ay, int delta, std::vector<double>& out) {
    init_sin_table();
    out.clear();
    const float alpha = sin_table[450], beta = sin_table[0];
    for (int i = 0; i < 360 + delta; i += delta) {
        int ang = i > 360 ? 360 : i;
        double x = ax * sin_table[450 - ang];
        double y = ay * sin_table[ang];
        out.push_back(cx + x * alpha - y * beta);
        out.push_back(cy + x * beta + y * alpha);
    }
    if (out.size() == 2) {
        out.assign({cx, cy, cx, cy});
    }
}

void thick_line(const Img& im, P2 p0, P2 p1, const uint8_t* c, int thickness, int line_type, int flags, int shift);

void polyline(const Img& im, const P2* v, int count, bool closed, const uint8_t* c,
              int thickness, int line_type, int shift) {
    if (count <= 0) return;
    int i = closed ? count - 1 : 0;
    int flags = 2 + !closed;
    P2 p0 = v[i];
    for (i = !closed; i < count; i++) {
        P2 p = v[i];
        thick_line(im, p0, p, c, thickness, line_type, flags, shift);
        p0 = p;
        flags = 2;
    }
}

// Full ellipse (OpenCV EllipseEx, angle 0, arc 0..360) in 16.16 fixed point.
void ellipse_ex(const Img& im, P2 center, int64_t axw, int64_t axh, const uint8_t* c,
                int thickness, int line_type) {
    axw = std::llabs(axw);
    axh = std::llabs(axh);
    int delta = (int)((std::max(axw, axh) + (XY_ONE >> 1)) >> XY_SHIFT);
    delta = delta < 3 ? 90 : delta < 10 ? 30 : delta < 15 ? 18 : 5;
    std::vector<double> dv;
    ellipse2poly((double)center.x, (double)center.y, (double)axw, (double)axh, delta, dv);
    std::vector<P2> v;
    P2 prev = {(int64_t)0xFFFFFFFFFFFFFFFFull, (int64_t)0xFFFFFFFFFFFFFFFFull};
    for (size_t k = 0; k < dv.size(); k += 2) {
        P2 pt;
        pt.x = (int64_t)cv_round(dv[k] / XY_ONE) << XY_SHIFT;
        pt.y = (int64_t)cv_round(dv[k + 1] / XY_ONE) << XY_SHIFT;
        pt.x += cv_round(dv[k] - pt.x);
        pt.y += cv_round(dv[k + 1] - pt.y);
        if (pt.x != prev.x || pt.y != prev.y) {
            v.push_back(pt);
            prev = pt;
        }
    }
    if (v.size() == 1) v.assign(2, center);
    if (thickness >= 0)
        polyline(im, v.data(), (int)v.size(), false, c, thickness, line_type, XY_SHIFT);
    else
        fill_convex_poly(im, v.data(), (int)v.size(), c, line_type, XY_SHIFT);
}

// One polyline segment with thickness and round caps (OpenCV ThickLine).
void thick_line(const Img& im, P2 p0, P2 p1, const uint8_t* c, int thickness, int line_type, int flags, int shift) {
    const double INV_XY_ONE = 1. / XY_ONE;
    if (thickness > 1) {
        // the centre segment is clipped to the image grown by `thickness`
        // on every side before it is thickened (integer endpoints; the
        // result differs from thickening the unclipped segment by ±1 px)
        int64_t pad = (int64_t)thickness << shift;
        p0.x += pad; p0.y += pad; p1.x += pad; p1.y += pad;
        bool ok = clip_line(((int64_t)im.w + 2 * thickness) << shift,
                            ((int64_t)im.h + 2 * thickness) << shift, p0.x, p0.y, p1.x, p1.y);
        p0.x -= pad; p0.y -= pad; p1.x -= pad; p1.y -= pad;
        if (!ok) return;
    }
    p0.x <<= XY_SHIFT - shift;
    p0.y <<= XY_SHIFT - shift;
    p1.x <<= XY_SHIFT - shift;
    p1.y <<= XY_SHIFT - shift;
    if (thickness <= 1) {
        if (line_type < LT_AA) {
            // thin non-AA segments round their fixed-point ends to pixels
            line8(im, (p0.x + (XY_ONE >> 1)) >> XY_SHIFT, (p0.y + (XY_ONE >> 1)) >> XY_SHIFT,
                  (p1.x + (XY_ONE >> 1)) >> XY_SHIFT, (p1.y + (XY_ONE >> 1)) >> XY_SHIFT, c);
        } else {
            line_aa(im, p0, p1, c);
        }
        return;
    }
    P2 pt[4];
    double dx = (p0.x - p1.x) * INV_XY_ONE, dy = (p1.y - p0.y) * INV_XY_ONE;
    double r = dx * dx + dy * dy;
    int odd = thickness & 1;
    thickness <<= XY_SHIFT - 1;
    if (std::fabs(r) > 2.220446049250313e-16) {
        r = (thickness + odd * XY_ONE * 0.5) / std::sqrt(r);
        int64_t dpx = cv_round(dy * r), dpy = cv_round(dx * r);
        pt[0] = {p0.x + dpx, p0.y + dpy};
        pt[1] = {p0.x - dpx, p0.y - dpy};
        pt[2] = {p1.x - dpx, p1.y - dpy};
        pt[3] = {p1.x + dpx, p1.y + dpy};
        fill_convex_poly(im, pt, 4, c, line_type, XY_SHIFT);
    }
    for (int i = 0; i < 2; i++) {
        if (flags & (i + 1)) {
            if (line_type < LT_AA) {
                int cx = (int)((p0.x + (XY_ONE >> 1)) >> XY_SHIFT);
                int cy = (int)((p0.y + (XY_ONE >> 1)) >> XY_SHIFT);
                circle_bres(im, cx, cy, (int)((thickness + (XY_ONE >> 1)) >> XY_SHIFT), c, true);
            } else {
                ellipse_ex(im, p0, thickness, thickness, c, -1, line_type);
            }
        }
        p0 = p1;
    }
}

// ---- minimum enclosing circle (OpenCV 5 shapedescr.cpp, float arithmetic)

const float MEC_EPS = 1.0e-4f;

// NB: the inner in-circle tests compare the double norm with the float
// radius; only the outer loop rounds the distance to float first.

struct F2 { float x, y; };

inline double dnorm(float x, float y) { return std::sqrt((double)x * x + (double)y * y); }
inline float fnorm(float x, float y) { return (float)dnorm(x, y); }

void circle3(const F2* p, F2& center, float& radius) {
    F2 v1 = {p[1].x - p[0].x, p[1].y - p[0].y};
    F2 v2 = {p[2].x - p[0].x, p[2].y - p[0].y};
    F2 m1 = {(p[0].x + p[1].x) / 2.0f, (p[0].y + p[1].y) / 2.0f};
    float c1 = m1.x * v1.x + m1.y * v1.y;
    F2 m2 = {(p[0].x + p[2].x) / 2.0f, (p[0].y + p[2].y) / 2.0f};
    float c2 = m2.x * v2.x + m2.y * v2.y;
    float det = v1.x * v2.y - v1.y * v2.x;
    // OpenCV 5 keeps the current circle for (near-)collinear triples; the
    // caller sees radius 0 and leaves its circle as it was.
    if (std::fabs(det) <= MEC_EPS) return;
    float cx = (c1 * v2.y - c2 * v1.y) / det;
    float cy = (v1.x * c2 - v2.x * c1) / det;
    center = {cx, cy};
    cx -= p[0].x;
    cy -= p[0].y;
    radius = std::sqrt(cx * cx + cy * cy) + MEC_EPS;
}

void third_point(const F2* pts, int i, int j, F2& center, float& radius) {
    center = {(pts[j].x + pts[i].x) / 2.0f, (pts[j].y + pts[i].y) / 2.0f};
    radius = fnorm(pts[j].x - pts[i].x, pts[j].y - pts[i].y) / 2.0f + MEC_EPS;
    for (int k = 0; k < j; ++k) {
        if (dnorm(center.x - pts[k].x, center.y - pts[k].y) < radius) continue;
        F2 tri[3] = {pts[i], pts[j], pts[k]};
        F2 nc; float nr = 0;
        circle3(tri, nc, nr);
        if (nr > 0) { radius = nr; center = nc; }
    }
}

void second_point(const F2* pts, int i, F2& center, float& radius) {
    center = {(pts[0].x + pts[i].x) / 2.0f, (pts[0].y + pts[i].y) / 2.0f};
    radius = fnorm(pts[0].x - pts[i].x, pts[0].y - pts[i].y) / 2.0f + MEC_EPS;
    for (int j = 1; j < i; ++j) {
        if (dnorm(center.x - pts[j].x, center.y - pts[j].y) < radius) continue;
        F2 nc; float nr = 0;
        third_point(pts, i, j, nc, nr);
        if (nr > 0) { radius = nr; center = nc; }
    }
}

}  // namespace

extern "C" {

// Draw `npoly` polylines (points int32 x,y; polyline k spans
// offs[k]..offs[k+1]) with cv2.polylines semantics; shift is the number of
// fractional bits of the coordinates.
void pw_draw_polylines(uint8_t* data, int h, int w, int cn, int64_t step, const int32_t* pts,
                       const int64_t* offs, int64_t npoly, int closed, const uint8_t* color,
                       int thickness, int line_type, int shift) {
    Img im = {data, h, w, cn, step};
    std::vector<P2> v;
    for (int64_t k = 0; k < npoly; ++k) {
        int64_t a = offs[k], b = offs[k + 1];
        v.resize((size_t)(b - a));
        for (int64_t t = a; t < b; ++t) v[(size_t)(t - a)] = {pts[2 * t], pts[2 * t + 1]};
        polyline(im, v.data(), (int)v.size(), closed != 0, color, thickness, line_type, shift);
    }
}

// cv2.circle: thickness < 0 fills.
void pw_draw_circle(uint8_t* data, int h, int w, int cn, int64_t step, int cx, int cy, int radius,
                    const uint8_t* color, int thickness, int line_type, int shift) {
    Img im = {data, h, w, cn, step};
    if (thickness > 1 || line_type != 8 || shift > 0) {
        P2 c = {(int64_t)cx << (XY_SHIFT - shift), (int64_t)cy << (XY_SHIFT - shift)};
        int64_t r = (int64_t)radius << (XY_SHIFT - shift);
        ellipse_ex(im, c, r, r, color, thickness, line_type);
    } else {
        circle_bres(im, cx, cy, radius, color, thickness < 0);
    }
}

// cv2.minEnclosingCircle over n float32 (x, y) points → out = (cx, cy, r).
// OpenCV 5 shuffles a copy of more than ten points before the Welzl loop,
// with a cv::RNG seeded from n and the bits of the first and last point.
void pw_min_enclosing_circle(const float* xy, int64_t n, float* out) {
    out[0] = out[1] = out[2] = 0.f;
    if (n <= 0) return;
    std::vector<F2> buf(reinterpret_cast<const F2*>(xy), reinterpret_cast<const F2*>(xy) + n);
    F2* pts = buf.data();
    if (n > 10) {
        uint32_t bits[4];
        std::memcpy(bits, &pts[0], 8);
        std::memcpy(bits + 2, &pts[n - 1], 8);
        uint64_t state = (uint32_t)n ^ bits[0] ^ (bits[1] << 8) ^ (bits[2] << 16) ^ (bits[3] << 24);
        if (state == 0) state = 0xffffffffu;
        for (uint32_t i = 2; i <= (uint32_t)n; ++i) {
            state = (uint64_t)(uint32_t)state * 4164903690u + (state >> 32);  // cv::RNG::next
            std::swap(pts[i - 1], pts[(uint32_t)state % i]);
        }
    }
    if (n == 1) {
        out[0] = pts[0].x; out[1] = pts[0].y; out[2] = MEC_EPS;
        return;
    }
    if (n == 2) {
        out[0] = (pts[0].x + pts[1].x) / 2.0f;
        out[1] = (pts[0].y + pts[1].y) / 2.0f;
        out[2] = (float)(std::sqrt((double)(pts[0].x - pts[1].x) * (pts[0].x - pts[1].x) +
                                   (double)(pts[0].y - pts[1].y) * (pts[0].y - pts[1].y)) / 2.0) + MEC_EPS;
        return;
    }
    F2 center = {(pts[0].x + pts[1].x) / 2.0f, (pts[0].y + pts[1].y) / 2.0f};
    float radius = fnorm(pts[0].x - pts[1].x, pts[0].y - pts[1].y) / 2.0f + MEC_EPS;
    for (int64_t i = 2; i < n; ++i) {
        if (fnorm(pts[i].x - center.x, pts[i].y - center.y) < radius) continue;
        F2 nc; float nr = 0;
        second_point(pts, (int)i, nc, nr);
        if (nr > 0) { radius = nr; center = nc; }
    }
    out[0] = center.x; out[1] = center.y; out[2] = radius;
}

// dst[p] = src[p] for every BGR pixel p of src that is not pure white
// (the preview composites' layer overlay).
void pw_copy_nonwhite(uint8_t* dst, const uint8_t* src, int64_t npix) {
    for (int64_t i = 0; i < npix; ++i, dst += 3, src += 3) {
        if ((src[0] & src[1] & src[2]) != 255) {
            dst[0] = src[0]; dst[1] = src[1]; dst[2] = src[2];
        }
    }
}

// Undo PNG scanline filters in place.  `rows` holds h rows of 1 + stride
// bytes (filter byte first); the unfiltered pixels go to `out` (h x stride).
// Returns 0, or -1 on an unknown filter type.
int pw_png_unfilter(const uint8_t* rows, int64_t h, int64_t stride, int bpp, uint8_t* out) {
    const uint8_t* prev = nullptr;
    for (int64_t y = 0; y < h; ++y) {
        const uint8_t* src = rows + y * (stride + 1);
        uint8_t ft = src[0];
        ++src;
        uint8_t* dst = out + y * stride;
        switch (ft) {
        case 0:
            std::memcpy(dst, src, (size_t)stride);
            break;
        case 1:
            for (int64_t i = 0; i < stride; ++i)
                dst[i] = (uint8_t)(src[i] + (i >= bpp ? dst[i - bpp] : 0));
            break;
        case 2:
            for (int64_t i = 0; i < stride; ++i)
                dst[i] = (uint8_t)(src[i] + (prev ? prev[i] : 0));
            break;
        case 3:
            for (int64_t i = 0; i < stride; ++i) {
                int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
                dst[i] = (uint8_t)(src[i] + ((a + b) >> 1));
            }
            break;
        case 4:
            for (int64_t i = 0; i < stride; ++i) {
                int a = i >= bpp ? dst[i - bpp] : 0, b = prev ? prev[i] : 0;
                int c = (i >= bpp && prev) ? prev[i - bpp] : 0;
                int p = a + b - c, pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
                int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
                dst[i] = (uint8_t)(src[i] + pred);
            }
            break;
        default:
            return -1;
        }
        prev = dst;
    }
    return 0;
}

}  // extern "C"
