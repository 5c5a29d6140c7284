// The largest external contour of binary windows, as the host stage's
// polygon step takes it from OpenCV:
//
//     contours, _ = cv2.findContours(window, RETR_EXTERNAL, CHAIN_APPROX_SIMPLE)
//     largest = max(contours, key=cv2.contourArea)
//
// findContours is Suzuki and Abe's border following over 8-connected
// foreground, on a copy of the window with a one-pixel border of zeros.  The
// raster scan, the marks it leaves (2 on a border pixel, 2 | 0x80 on one
// whose right neighbour is background), the neighbour search, the start
// point and the simple chain approximation below follow OpenCV's own
// (imgproc/src/contours_new.cpp, as in contours.cpp before it) step for
// step, so the points come out the same, in the same order
// (tests/test_torch_native_contours.py holds them to OpenCV 4.13's and
// 5.0's).  OpenCV returns the external contours in the reverse of the order
// the scan finds them; max() keeps the first of equal areas in that order,
// which is the last one found.  The area is contourArea's shoelace sum in
// double, in its order.
//
// One call serves every word of a launch: it reads each word's window in
// place (offset, width and height in the windows' buffer, and the box of its
// foreground, outside which the window is zero), and writes the largest
// contour's points, packed, into the caller's buffer.  Built with g++ and
// loaded through ctypes, whose calls release the interpreter lock.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

// OpenCV's chain codes: 0 is +x, counted counter-clockwise on the screen
// (y grows downwards).
const int kDx[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDy[8] = {0, -1, -1, -1, 0, 1, 1, 1};

const int8_t kNew = 2;
const int8_t kRight = -128;  // 0x80: the pixel's right neighbour is background

struct Scratch {
    std::vector<int8_t> img;     // the window's foreground box, zero-padded
    std::vector<int32_t> cur;    // the contour being followed, x y pairs
    std::vector<int32_t> best;   // the largest so far
};

// Follows the outer border that starts at pixel (x, y) of the padded image
// (the first foreground pixel of its component in raster order), marking it
// as OpenCV does, and appends its points, less the padding, to `pts`.
void follow(int8_t* img, int step, int x, int y, std::vector<int32_t>& pts) {
    int delta[16];
    for (int s = 0; s < 8; ++s) delta[s] = delta[s + 8] = kDx[s] + kDy[s] * step;
    int8_t* const i0 = img + (size_t)y * step + x;
    int8_t* i1;
    int s_end = 4, s = 4;
    pts.clear();
    do {
        s = (s - 1) & 7;
        i1 = i0 + delta[s];
    } while (*i1 == 0 && s != s_end);
    if (s == s_end) {  // a single pixel
        *i0 = (int8_t)(kNew | kRight);
        pts.push_back(x - 1);
        pts.push_back(y - 1);
        return;
    }
    int8_t* i3 = i0;
    int8_t* i4;
    int prev_s = s ^ 4;
    int px = x, py = y;
    for (;;) {
        s_end = s;
        for (;;) {  // s + 8 is the pixel we came from, never background
            i4 = i3 + delta[++s];
            if (*i4 != 0) break;
        }
        s &= 7;
        if ((unsigned)(s - 1) < (unsigned)s_end) {
            *i3 = (int8_t)(kNew | kRight);
        } else if (*i3 == 1) {
            *i3 = kNew;
        }
        if (s != prev_s) {
            pts.push_back(px - 1);
            pts.push_back(py - 1);
            prev_s = s;
        }
        px += kDx[s];
        py += kDy[s];
        if (i4 == i0 && i3 == i1) break;
        i3 = i4;
        s = (s + 4) & 7;
    }
}

double contour_area(const std::vector<int32_t>& pts) {
    const size_t n = pts.size() / 2;
    if (n == 0) return 0.0;
    double a00 = 0.0;
    float qx = (float)pts[2 * n - 2], qy = (float)pts[2 * n - 1];
    for (size_t i = 0; i < n; ++i) {
        const float x = (float)pts[2 * i], y = (float)pts[2 * i + 1];
        a00 += (double)qx * y - (double)qy * x;
        qx = x;
        qy = y;
    }
    a00 *= 0.5;
    return std::fabs(a00);
}

// Word-at-a-time searches along a row: the scan's runs are most of a
// window.  Each stays before `end`, where the row's padding is.
static_assert(__BYTE_ORDER__ == __ORDER_LITTLE_ENDIAN__, "the searches read bytes from the low end");
inline uint64_t load8(const int8_t* p) {
    uint64_t v;
    std::memcpy(&v, p, 8);
    return v;
}

const uint64_t kOnes = 0x0101010101010101ull;

// The first column from x on that is foreground, or `end`.
inline int next_foreground(const int8_t* row, int x, int end) {
    for (; x + 8 <= end; x += 8) {
        const uint64_t v = load8(row + x);
        if (v != 0) return x + __builtin_ctzll(v) / 8;
    }
    while (x < end && row[x] == 0) ++x;
    return x;
}

// The first column from x on that is background (`end` is).
inline int next_background(const int8_t* row, int x, int end) {
    for (; x + 8 <= end; x += 8) {
        const uint64_t v = load8(row + x);
        const uint64_t zero = (v - kOnes) & ~v & (kOnes << 7);  // lowest flag exact
        if (zero != 0) return x + __builtin_ctzll(zero) / 8;
    }
    while (x < end && row[x] != 0) ++x;
    return x;
}

// The last column of a..b that is marked (not 1), or a - 1.
inline int last_marked(const int8_t* row, int a, int b) {
    for (; b - 8 + 1 >= a; b -= 8) {
        const uint64_t v = load8(row + b - 7) ^ kOnes;
        if (v != 0) return b - __builtin_clzll(v) / 8;
    }
    while (b >= a && row[b] == 1) --b;
    return b;
}

// The largest external contour of one window (row stride w) whose
// foreground lies in columns bx0..bx1 and rows by0..by1, into sc.best, in
// the coordinates of that box.
void largest(const uint8_t* win, int64_t w, int bx0, int by0, int bx1, int by1, Scratch& sc) {
    const int fw = bx1 - bx0 + 1, fh = by1 - by0 + 1;
    const int step = fw + 2;
    sc.img.resize((size_t)step * (fh + 2));
    int8_t* img = sc.img.data();
    std::memset(img, 0, step);
    std::memset(img + (size_t)(fh + 1) * step, 0, step);
    for (int y = 0; y < fh; ++y) {
        const uint8_t* row = win + (by0 + y) * w + bx0;
        int8_t* out = img + (size_t)(y + 1) * step;
        out[0] = out[fw + 1] = 0;
        for (int x = 0; x < fw; ++x) out[x + 1] = row[x] != 0;
    }
    sc.best.clear();
    double best_area = -1.0;
    // OpenCV's scan, external contours only, a run of foreground at a time.
    // Pixel by pixel it keeps `lnbd`, the last marked pixel met on the row:
    // it moves to a pixel whose value differs from the one before it and is
    // marked (but not to the pixel a border was just followed from), and to
    // the last pixel of a run ending in a 2.  A run's first pixel starts a
    // border when it is unmarked and the pixel at `lnbd` is not a 2 (which
    // would put it inside a component already followed).  The components
    // this skips lie in holes, inside a larger contour, so they never change
    // the largest; the rule saves following them.
    const int end = fw + 1;
    for (int y = 1; y < fh + 1; ++y) {
        int8_t* row = img + (size_t)y * step;
        int lnbd = 0;
        for (int a = next_foreground(row, 1, end); a < end;) {
            bool followed = false;
            if (row[a] == 1 && row[lnbd] <= 0) {
                follow(img, step, a, y, sc.cur);
                followed = true;
                const double area = contour_area(sc.cur);
                if (area >= best_area) {  // the last found of equal areas
                    best_area = area;
                    sc.best.swap(sc.cur);
                }
            }
            const int b = next_background(row, a + 1, end) - 1;
            if (row[b] == kNew) {
                lnbd = b;
            } else {
                const int m = last_marked(row, a, b);
                if (m >= a) {
                    int s = m;
                    while (s > a && row[s - 1] == row[m]) --s;
                    if (s > a || !followed) lnbd = s;
                }
            }
            a = next_foreground(row, b + 2, end);
        }
    }
}

}  // namespace

extern "C" {

// Every word j of one launch of n: the window of geo[j] = (offset, width,
// height) in `base`, its foreground box fg[j] = (x0, y0, x1, y1) (x1 < 0:
// none), skipped where skip[j] is set.  Writes counts[j], the points of the
// largest contour (0 for none, for fewer than 3 points and for a skipped
// word), and the points themselves as int32 (x, y) pairs in the foreground
// box's coordinates, word after word, into pts while they fit in `capacity`
// points; a word that does not fit reads -1.  Returns the points every word
// needs together.
int64_t contours_largest(const uint8_t* base, const int64_t* geo, const int32_t* fg,
                         const int32_t* skip, int32_t n, int32_t* pts, int64_t capacity,
                         int32_t* counts) {
    thread_local Scratch sc;
    int64_t used = 0, need = 0;
    for (int32_t j = 0; j < n; ++j) {
        counts[j] = 0;
        const int32_t* b = fg + 4 * j;
        if ((skip != nullptr && skip[j]) || b[2] < 0) continue;
        largest(base + geo[3 * j], geo[3 * j + 1], b[0], b[1], b[2], b[3], sc);
        const int64_t k = (int64_t)sc.best.size() / 2;
        if (k < 3) continue;
        need += k;
        if (used + k > capacity) {
            counts[j] = -1;
            continue;
        }
        std::memcpy(pts + 2 * used, sc.best.data(), sizeof(int32_t) * 2 * k);
        used += k;
        counts[j] = (int32_t)k;
    }
    return need;
}

}  // extern "C"
