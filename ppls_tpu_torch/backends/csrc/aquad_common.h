/* Shared numerics + task-bag for the C backends of ppls_tpu_torch (a
 * copy of the reference package's backends/csrc).
 *
 * Original implementation of the capabilities of the reference's
 * quadrature core (cf. aquadPartA.c:183-202) and task bag (:52-70,
 * :210-259), redesigned rather than translated:
 *   - 3 distinct integrand evaluations per task (the reference's macro
 *     expansion spends 5 — SURVEY.md §2 defects);
 *   - array-backed growable bag instead of a malloc-per-node linked list
 *     (no per-task allocations, no leaks);
 *   - depth tracked per task so max refinement depth is reported;
 *   - Neumaier-compensated accumulation instead of bare `+=`.
 */
#ifndef AQUAD_COMMON_H
#define AQUAD_COMMON_H

#include <math.h>
#include <stdio.h>
#include <stdlib.h>
#include <time.h>

/* ---- integrand registry (ids must match mpi_backend._C_INTEGRANDS) ---- */

/* aq_scale parameterizes fid 3 (the "family" integrand sin(s/x), matching
 * the registry's sin_recip_scaled) — set from argv before use. */
static double aq_scale = 1.0;

static double f_eval(int fid, double x) {
    switch (fid) {
    case 0: { double c = cosh(x); double c2 = c * c; return c2 * c2; }
    case 1: return sin(x);
    case 2: return sin(1.0 / x);
    case 3: return sin(aq_scale / x);
    default:
        fprintf(stderr, "unknown integrand id %d\n", fid);
        exit(2);
    }
}

/* ---- adaptive trapezoid test: 3-point evaluate-or-split ---- */

/* Returns nonzero when [l, r] must split; *value receives the refined
 * (two-half) trapezoid value, accepted when no split. Semantics match the
 * reference test (strict >, accepted value = sum of half trapezoids). */
static int aq_eval(int fid, double eps, double l, double r, double *value) {
    double fl = f_eval(fid, l);
    double fr = f_eval(fid, r);
    double m = 0.5 * (l + r);
    double fm = f_eval(fid, m);
    double whole = 0.5 * (fl + fr) * (r - l);
    double halves = 0.5 * (fl + fm) * (m - l) + 0.5 * (fm + fr) * (r - m);
    *value = halves;
    return fabs(halves - whole) > eps;
}

/* ---- compensated accumulator ---- */

typedef struct { double s, c; } acc_t;

static void acc_add(acc_t *a, double x) {
    double t = a->s + x;
    if (fabs(a->s) >= fabs(x))
        a->c += (a->s - t) + x;
    else
        a->c += (x - t) + a->s;
    a->s = t;
}

static double acc_value(const acc_t *a) { return a->s + a->c; }

/* ---- array-backed LIFO bag of tasks ---- */

typedef struct { double l, r; int depth; } aq_task;

typedef struct {
    aq_task *items;
    size_t len, cap;
} aq_bag;

static void bag_init(aq_bag *b) {
    b->cap = 1024;
    b->len = 0;
    b->items = (aq_task *)malloc(b->cap * sizeof(aq_task));
    if (!b->items) { perror("malloc"); exit(2); }
}

static void bag_push(aq_bag *b, double l, double r, int depth) {
    if (b->len == b->cap) {
        b->cap *= 2;
        b->items = (aq_task *)realloc(b->items, b->cap * sizeof(aq_task));
        if (!b->items) { perror("realloc"); exit(2); }
    }
    b->items[b->len].l = l;
    b->items[b->len].r = r;
    b->items[b->len].depth = depth;
    b->len++;
}

static int bag_pop(aq_bag *b, aq_task *out) {
    if (b->len == 0) return 0;
    b->len--;
    *out = b->items[b->len];
    return 1;
}

static void bag_free(aq_bag *b) {
    free(b->items);
    b->items = NULL;
    b->len = b->cap = 0;
}

/* ---- misc ---- */

static double now_sec(void) {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

#endif /* AQUAD_COMMON_H */
