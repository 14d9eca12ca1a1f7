/* Single-process MPI stub: the six MPI calls aquad_mpi.c uses —
 * MPI_Init / MPI_Comm_rank / MPI_Comm_size / MPI_Send / MPI_Recv /
 * MPI_Finalize — implemented over in-process mailboxes (one mutex +
 * condvar message queue per rank, each rank a pthread), so the
 * farmer/worker PROTOCOL executes for real on hosts with no MPI
 * toolchain (VERDICT Missing #1: the golden parity test previously
 * skipped wherever mpicc/mpirun were absent — i.e. everywhere this
 * repo is developed).
 *
 * Build:  cc -O2 -DAQ_MPI_STUB -o aquad_mpi_stub aquad_mpi.c -lm -lpthread
 *
 * How it runs one binary as P ranks: this header provides the real
 * main(), which reads the process count from $AQ_STUB_NP, spawns ranks
 * 1..P-1 as threads, runs rank 0 on the main thread, and joins. The
 * trailing `#define main aq_stub_user_main` renames the program's own
 * main (defined after this include) into the per-rank entry point;
 * rank identity is a thread-local.
 *
 * Semantics covered (exactly what aquad_mpi.c exercises):
 *   - point-to-point sends of <= AQ_STUB_MAXN doubles, buffered,
 *     non-blocking (MPI_Send never blocks: queues are unbounded);
 *   - MPI_Recv with MPI_ANY_SOURCE / MPI_ANY_TAG wildcards, FIFO
 *     within a matching (source, tag) pair — MPI's non-overtaking
 *     guarantee, preserved here because the scan takes the FIRST
 *     queued match;
 *   - MPI_Status.MPI_SOURCE / MPI_TAG.
 * Not covered (not needed here): collectives, non-blocking ops,
 * datatypes other than MPI_DOUBLE, communicators beyond WORLD.
 */
#ifndef AQ_MPI_STUB_H
#define AQ_MPI_STUB_H

#include <pthread.h>
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define MPI_COMM_WORLD 0
#define MPI_DOUBLE 0
#define MPI_ANY_SOURCE (-1)
#define MPI_ANY_TAG (-1)

typedef int MPI_Comm;
typedef int MPI_Datatype;
typedef struct {
    int MPI_SOURCE;
    int MPI_TAG;
} MPI_Status;

#define AQ_STUB_MAXN 8 /* doubles per message; aquad_mpi.c sends 2 */

typedef struct aq_stub_msg {
    int src, tag, count;
    double data[AQ_STUB_MAXN];
    struct aq_stub_msg *next;
} aq_stub_msg;

typedef struct {
    pthread_mutex_t mu;
    pthread_cond_t cv;
    aq_stub_msg *head, *tail;
} aq_stub_mailbox;

static int aq_stub_nprocs = 0;
static aq_stub_mailbox *aq_stub_mail = NULL;
static __thread int aq_stub_rank = 0;
static int aq_stub_argc;
static char **aq_stub_argv;

int aq_stub_user_main(int argc, char **argv);

static int MPI_Init(int *argc, char ***argv) {
    (void)argc;
    (void)argv;
    return 0;
}

static int MPI_Comm_rank(MPI_Comm comm, int *rank) {
    (void)comm;
    *rank = aq_stub_rank;
    return 0;
}

static int MPI_Comm_size(MPI_Comm comm, int *size) {
    (void)comm;
    *size = aq_stub_nprocs;
    return 0;
}

static int MPI_Finalize(void) { return 0; }

static int MPI_Send(const void *buf, int count, MPI_Datatype dt,
                    int dest, int tag, MPI_Comm comm) {
    (void)dt;
    (void)comm;
    if (count > AQ_STUB_MAXN || dest < 0 || dest >= aq_stub_nprocs) {
        fprintf(stderr, "mpi_stub: bad send (count=%d dest=%d)\n",
                count, dest);
        exit(2);
    }
    aq_stub_msg *m = (aq_stub_msg *)malloc(sizeof *m);
    if (!m) { perror("malloc"); exit(2); }
    m->src = aq_stub_rank;
    m->tag = tag;
    m->count = count;
    m->next = NULL;
    memcpy(m->data, buf, (size_t)count * sizeof(double));
    aq_stub_mailbox *mb = &aq_stub_mail[dest];
    pthread_mutex_lock(&mb->mu);
    if (mb->tail)
        mb->tail->next = m;
    else
        mb->head = m;
    mb->tail = m;
    pthread_cond_broadcast(&mb->cv);
    pthread_mutex_unlock(&mb->mu);
    return 0;
}

static int MPI_Recv(void *buf, int count, MPI_Datatype dt, int src,
                    int tag, MPI_Comm comm, MPI_Status *st) {
    (void)dt;
    (void)comm;
    aq_stub_mailbox *mb = &aq_stub_mail[aq_stub_rank];
    pthread_mutex_lock(&mb->mu);
    for (;;) {
        aq_stub_msg *prev = NULL, *m = mb->head;
        while (m) {
            if ((src == MPI_ANY_SOURCE || m->src == src) &&
                (tag == MPI_ANY_TAG || m->tag == tag))
                break;
            prev = m;
            m = m->next;
        }
        if (m) {
            if (prev)
                prev->next = m->next;
            else
                mb->head = m->next;
            if (mb->tail == m)
                mb->tail = prev;
            pthread_mutex_unlock(&mb->mu);
            int n = m->count < count ? m->count : count;
            memcpy(buf, m->data, (size_t)n * sizeof(double));
            if (st) {
                st->MPI_SOURCE = m->src;
                st->MPI_TAG = m->tag;
            }
            free(m);
            return 0;
        }
        pthread_cond_wait(&mb->cv, &mb->mu);
    }
}

static void *aq_stub_thread(void *arg) {
    aq_stub_rank = (int)(intptr_t)arg;
    aq_stub_user_main(aq_stub_argc, aq_stub_argv);
    return NULL;
}

int main(int argc, char **argv) {
    const char *np = getenv("AQ_STUB_NP");
    aq_stub_nprocs = np ? atoi(np) : 5;
    if (aq_stub_nprocs < 2)
        aq_stub_nprocs = 2;
    aq_stub_argc = argc;
    aq_stub_argv = argv;
    aq_stub_mail = (aq_stub_mailbox *)calloc((size_t)aq_stub_nprocs,
                                             sizeof(aq_stub_mailbox));
    if (!aq_stub_mail) { perror("calloc"); exit(2); }
    for (int i = 0; i < aq_stub_nprocs; i++) {
        pthread_mutex_init(&aq_stub_mail[i].mu, NULL);
        pthread_cond_init(&aq_stub_mail[i].cv, NULL);
    }
    pthread_t *tids =
        (pthread_t *)malloc((size_t)aq_stub_nprocs * sizeof(pthread_t));
    if (!tids) { perror("malloc"); exit(2); }
    for (int w = 1; w < aq_stub_nprocs; w++) {
        if (pthread_create(&tids[w], NULL, aq_stub_thread,
                           (void *)(intptr_t)w)) {
            perror("pthread_create");
            exit(2);
        }
    }
    aq_stub_rank = 0;
    int rc = aq_stub_user_main(argc, argv);
    for (int w = 1; w < aq_stub_nprocs; w++)
        pthread_join(tids[w], NULL);
    free(tids);
    return rc;
}

/* Rename the program's own main (defined after this include) into the
 * per-rank entry point the spawner above calls. */
#define main aq_stub_user_main

#endif /* AQ_MPI_STUB_H */
