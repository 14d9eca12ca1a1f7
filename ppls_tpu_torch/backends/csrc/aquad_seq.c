/* Sequential adaptive-quadrature driver: the single-process CPU baseline
 * (BASELINE.json config "single-process CPU ref"; throughput denominator
 * for bench.py's vs_baseline ratio).
 *
 * Usage (1D): aquad_seq <integrand_id> <a> <b> <eps> [scale]
 * Usage (2D): aquad_seq 2d <fid2> <ax> <bx> <ay> <by> <eps> [sigma]
 * Output: one JSON line with area, counters, timing.
 *
 * The 2D mode is the rectangle-bag twin of the reference package's
 * cubature engine (parallel/cubature.py, TRAPEZOID rule): the same 9-point
 * 3x3 evaluate-or-split test as ops/rules2d.trapezoid_rect_batch —
 * coarse = corner-average x area, refined = sum of the four half-size
 * sub-cell trapezoids, strict-> split into quadrants — on the peaked
 * 2D Gaussian exp(-((x-.5)^2+(y-.5)^2)/(2 sigma^2)). It exists so the
 * 2D secondary bench has a REAL single-process CPU denominator
 * (BASELINE #4 / VERDICT r5 #2), like the 1D mode above is for the
 * flagship. Cells and split decisions match that engine exactly
 * (both f64, same test), so the area cross-check is ~1e-12-tight.
 */
#include "aquad_common.h"
#include <string.h>

/* ---- 2D rectangle bag (the ~40-line 2D twin of aq_bag) ---- */

typedef struct { double lx, rx, ly, ry; int depth; } rect_task;
typedef struct { rect_task *items; size_t len, cap; } rect_bag;

static void rbag_push(rect_bag *b, double lx, double rx, double ly,
                      double ry, int depth) {
    if (b->len == b->cap) {
        b->cap *= 2;
        b->items = (rect_task *)realloc(b->items,
                                        b->cap * sizeof(rect_task));
        if (!b->items) { perror("realloc"); exit(2); }
    }
    rect_task *t = &b->items[b->len++];
    t->lx = lx; t->rx = rx; t->ly = ly; t->ry = ry; t->depth = depth;
}

static double g2_sigma = 0.05;   /* gauss2d_peak default (models) */
static int g2_fid = 0;           /* 0: peak; 1: ring (r0 = 0.3) */

static double f2(double x, double y) {
    double dx = x - 0.5, dy = y - 0.5;
    if (g2_fid == 1) {
        /* Gaussian ridge along the circle r = 0.3 (gauss2d_ring in
         * models/integrands.py): refinement hugs a 1D curve, so the
         * cell count scales like curve-length/h — the deep-workload
         * variant the timed 2D bench uses. */
        double r = sqrt(dx * dx + dy * dy);
        double u = (r - 0.3) / g2_sigma;
        return exp(-u * u);
    }
    dx /= g2_sigma; dy /= g2_sigma;
    return exp(-0.5 * (dx * dx + dy * dy));
}

static int main_2d(int argc, char **argv) {
    if (argc != 8 && argc != 9) {
        fprintf(stderr,
                "usage: %s 2d <fid2> <ax> <bx> <ay> <by> <eps> [sigma]\n",
                argv[0]);
        return 2;
    }
    g2_fid = atoi(argv[2]);
    double ax = strtod(argv[3], NULL), bx = strtod(argv[4], NULL);
    double ay = strtod(argv[5], NULL), by = strtod(argv[6], NULL);
    double eps = strtod(argv[7], NULL);
    if (argc == 9)
        g2_sigma = strtod(argv[8], NULL);

    rect_bag bag = {NULL, 0, 1024};
    bag.items = (rect_task *)malloc(bag.cap * sizeof(rect_task));
    if (!bag.items) { perror("malloc"); return 2; }
    rbag_push(&bag, ax, bx, ay, by, 0);

    acc_t area = {0.0, 0.0};
    long cells = 0, splits = 0;
    int max_depth = 0;

    double t0 = now_sec();
    while (bag.len) {
        rect_task t = bag.items[--bag.len];
        cells++;
        if (t.depth > max_depth) max_depth = t.depth;
        double mx = 0.5 * (t.lx + t.rx), my = 0.5 * (t.ly + t.ry);
        /* 9-point 3x3 grid, each point evaluated once (rules2d) */
        double f00 = f2(t.lx, t.ly), f01 = f2(t.lx, my),
               f02 = f2(t.lx, t.ry), f10 = f2(mx, t.ly),
               f11 = f2(mx, my),     f12 = f2(mx, t.ry),
               f20 = f2(t.rx, t.ly), f21 = f2(t.rx, my),
               f22 = f2(t.rx, t.ry);
        double a = (t.rx - t.lx) * (t.ry - t.ly);
        double coarse = 0.25 * (f00 + f02 + f20 + f22) * a;
        double q = (f00 + f01 + f10 + f11) + (f01 + f02 + f11 + f12)
                 + (f10 + f11 + f20 + f21) + (f11 + f12 + f21 + f22);
        double refined = 0.0625 * q * a;
        if (fabs(refined - coarse) > eps) {
            rbag_push(&bag, t.lx, mx, t.ly, my, t.depth + 1);
            rbag_push(&bag, mx, t.rx, t.ly, my, t.depth + 1);
            rbag_push(&bag, t.lx, mx, my, t.ry, t.depth + 1);
            rbag_push(&bag, mx, t.rx, my, t.ry, t.depth + 1);
            splits++;
        } else {
            acc_add(&area, refined);
        }
    }
    double wall = now_sec() - t0;
    free(bag.items);

    printf("{\"area\": %.17g, \"tasks\": %ld, \"splits\": %ld, "
           "\"evals\": %ld, \"max_depth\": %d, \"wall_time_s\": %.9f}\n",
           acc_value(&area), cells, splits, 9 * cells, max_depth, wall);
    return 0;
}

int main(int argc, char **argv) {
    if (argc >= 2 && strcmp(argv[1], "2d") == 0)
        return main_2d(argc, argv);
    if (argc != 5 && argc != 6) {
        fprintf(stderr,
                "usage: %s <integrand_id> <a> <b> <eps> [scale]\n"
                "       %s 2d <fid2> <ax> <bx> <ay> <by> <eps> [sigma]\n",
                argv[0], argv[0]);
        return 2;
    }
    int fid = atoi(argv[1]);
    double a = strtod(argv[2], NULL);
    double b = strtod(argv[3], NULL);
    double eps = strtod(argv[4], NULL);
    if (argc == 6)
        aq_scale = strtod(argv[5], NULL);

    aq_bag bag;
    bag_init(&bag);
    bag_push(&bag, a, b, 0);

    acc_t area = {0.0, 0.0};
    long tasks = 0, splits = 0;
    int max_depth = 0;
    aq_task t;

    double t0 = now_sec();
    while (bag_pop(&bag, &t)) {
        double v;
        tasks++;
        if (t.depth > max_depth) max_depth = t.depth;
        if (aq_eval(fid, eps, t.l, t.r, &v)) {
            double m = 0.5 * (t.l + t.r);
            bag_push(&bag, t.l, m, t.depth + 1);
            bag_push(&bag, m, t.r, t.depth + 1);
            splits++;
        } else {
            acc_add(&area, v);
        }
    }
    double wall = now_sec() - t0;
    bag_free(&bag);

    printf("{\"area\": %.17g, \"tasks\": %ld, \"splits\": %ld, "
           "\"evals\": %ld, \"max_depth\": %d, \"wall_time_s\": %.9f}\n",
           acc_value(&area), tasks, splits, 3 * tasks, max_depth, wall);
    return 0;
}
