/* MPI farmer/worker adaptive quadrature — an original implementation of
 * the reference's architecture (aquadPartA.c:125-208), redesigned:
 *
 *   - The farmer remembers which interval each worker holds, so a worker
 *     replies with ONE message {split_flag, value}; on a split the farmer
 *     derives both halves itself. The reference instead has the worker
 *     send the two halves as a pair of tag-0 messages matched by a second
 *     targeted recv (aquadPartA.c:151-155) — 2 messages per task here vs
 *     up to 4 there.
 *   - Idle workers sit in an explicit FIFO ring of ranks; dispatch pops
 *     from it instead of rescanning a flag array (cf. the scan at
 *     aquadPartA.c:156-165).
 *   - Termination (bag empty ∧ nothing outstanding) is detected via an
 *     outstanding-task counter rather than an idle-count comparison.
 *
 * Usage: mpirun -n <P> aquad_mpi <integrand_id> <a> <b> <eps>   (P >= 2)
 * Output (rank 0): one JSON line with area, counters, timing.
 *
 * Built with -DAQ_MPI_STUB the same source links against the
 * single-process in-memory MPI subset in mpi_stub.h (ranks are
 * threads, messages are mutex/condvar mailboxes; run count via
 * $AQ_STUB_NP) — the farmer/worker protocol then executes on hosts
 * with no MPI toolchain at all.
 */
#ifdef AQ_MPI_STUB
#include "mpi_stub.h"
#else
#include <mpi.h>
#endif

#include "aquad_common.h"

enum { TAG_WORK = 10, TAG_STOP = 11, TAG_RESULT = 12 };

/* worker -> farmer payload: {kind, value}; kind: -1 register, 0 leaf
 * area in value, 1 split request (value unused). */

static void farmer(int nprocs, int fid, double a, double b, double eps) {
    /* fid/eps are worker-side (the farmer only routes intervals); they
     * stay in the signature so farmer/worker share the argv contract */
    (void)fid;
    (void)eps;
    aq_bag bag;
    bag_init(&bag);
    bag_push(&bag, a, b, 0);

    /* current task held by each worker rank (index 1..nprocs-1) */
    aq_task *held = (aq_task *)calloc((size_t)nprocs, sizeof(aq_task));
    long *tasks_per_rank = (long *)calloc((size_t)nprocs, sizeof(long));
    /* FIFO ring of idle ranks */
    int *idle_ring = (int *)malloc((size_t)nprocs * sizeof(int));
    int ring_head = 0, ring_tail = 0, n_idle = 0;
    if (!held || !tasks_per_rank || !idle_ring) { perror("alloc"); exit(2); }

    acc_t area = {0.0, 0.0};
    long tasks = 0, splits = 0;
    int max_depth = 0;
    int outstanding = 0;

    double t0 = now_sec();
    for (;;) {
        /* dispatch while we have both work and idle workers */
        while (bag.len > 0 && n_idle > 0) {
            int w = idle_ring[ring_head];
            ring_head = (ring_head + 1) % nprocs;
            n_idle--;
            aq_task t;
            bag_pop(&bag, &t);
            held[w] = t;
            double msg[2] = {t.l, t.r};
            MPI_Send(msg, 2, MPI_DOUBLE, w, TAG_WORK, MPI_COMM_WORLD);
            tasks_per_rank[w]++;
            tasks++;
            outstanding++;
            if (t.depth > max_depth) max_depth = t.depth;
        }
        if (bag.len == 0 && outstanding == 0)
            break; /* nothing pending anywhere: done */

        double resp[2];
        MPI_Status st;
        MPI_Recv(resp, 2, MPI_DOUBLE, MPI_ANY_SOURCE, TAG_RESULT,
                 MPI_COMM_WORLD, &st);
        int w = st.MPI_SOURCE;
        int kind = (int)resp[0];
        if (kind == 0) { /* accepted leaf */
            acc_add(&area, resp[1]);
            outstanding--;
        } else if (kind == 1) { /* split: farmer derives the halves */
            aq_task t = held[w];
            double m = 0.5 * (t.l + t.r);
            bag_push(&bag, t.l, m, t.depth + 1);
            bag_push(&bag, m, t.r, t.depth + 1);
            splits++;
            outstanding--;
        } /* kind == -1: registration, nothing to account */
        idle_ring[ring_tail] = w;
        ring_tail = (ring_tail + 1) % nprocs;
        n_idle++;
    }
    double wall = now_sec() - t0;

    for (int w = 1; w < nprocs; w++) {
        double stop[2] = {0.0, 0.0};
        MPI_Send(stop, 2, MPI_DOUBLE, w, TAG_STOP, MPI_COMM_WORLD);
    }

    printf("{\"area\": %.17g, \"tasks\": %ld, \"splits\": %ld, "
           "\"evals\": %ld, \"max_depth\": %d, \"wall_time_s\": %.9f, "
           "\"tasks_per_rank\": [",
           acc_value(&area), tasks, splits, 3 * tasks, max_depth, wall);
    for (int i = 0; i < nprocs; i++)
        printf("%s%ld", i ? ", " : "", tasks_per_rank[i]);
    printf("]}\n");

    bag_free(&bag);
    free(held);
    free(tasks_per_rank);
    free(idle_ring);
}

static void worker(int fid, double eps) {
    double reg[2] = {-1.0, 0.0};
    MPI_Send(reg, 2, MPI_DOUBLE, 0, TAG_RESULT, MPI_COMM_WORLD);
    for (;;) {
        double msg[2];
        MPI_Status st;
        MPI_Recv(msg, 2, MPI_DOUBLE, 0, MPI_ANY_TAG, MPI_COMM_WORLD, &st);
        if (st.MPI_TAG == TAG_STOP)
            return;
        double v;
        int split = aq_eval(fid, eps, msg[0], msg[1], &v);
        double resp[2] = {split ? 1.0 : 0.0, v};
        MPI_Send(resp, 2, MPI_DOUBLE, 0, TAG_RESULT, MPI_COMM_WORLD);
    }
}

int main(int argc, char **argv) {
    MPI_Init(&argc, &argv);
    int rank, nprocs;
    MPI_Comm_rank(MPI_COMM_WORLD, &rank);
    MPI_Comm_size(MPI_COMM_WORLD, &nprocs);

    if (argc != 5) {
        if (rank == 0)
            fprintf(stderr, "usage: %s <integrand_id> <a> <b> <eps>\n",
                    argv[0]);
        MPI_Finalize();
        return 2;
    }
    if (nprocs < 2) {
        if (rank == 0)
            fprintf(stderr, "need at least 2 processes (1 farmer + 1 "
                            "worker)\n");
        MPI_Finalize();
        return 2;
    }

    int fid = atoi(argv[1]);
    double a = strtod(argv[2], NULL);
    double b = strtod(argv[3], NULL);
    double eps = strtod(argv[4], NULL);

    if (rank == 0)
        farmer(nprocs, fid, a, b, eps);
    else
        worker(fid, eps);

    MPI_Finalize();
    return 0;
}
