/* Parallel batch-collation kernel: gather rows of a C-contiguous array into
 * a contiguous batch buffer with a thread pool.
 *
 * The data loader's one heavy host-side op is this row gather, done with
 * raw memcpy across threads (numpy fancy indexing is single-threaded).
 * Loaded via ctypes by deepspeed_tpu_torch/native/__init__.py, which falls
 * back to numpy when no C toolchain is available.
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    char *dst;
    const char *src;
    const int64_t *idx;
    int64_t begin;      /* first output row (inclusive) */
    int64_t end;        /* last output row (exclusive)  */
    int64_t row_bytes;
} gather_task;

static void *gather_worker(void *arg) {
    gather_task *t = (gather_task *)arg;
    const int64_t rb = t->row_bytes;
    for (int64_t r = t->begin; r < t->end; ++r) {
        memcpy(t->dst + r * rb, t->src + t->idx[r] * rb, (size_t)rb);
    }
    return NULL;
}

/* Gather rows src[idx[i]] -> dst[i] for i in [0, n_rows).
 * Caller guarantees: dst has n_rows*row_bytes bytes, every idx in range,
 * both buffers C-contiguous.  Returns 0 on success. */
int gather_rows(char *dst, const char *src, const int64_t *idx,
                int64_t n_rows, int64_t row_bytes, int n_threads) {
    if (n_rows <= 0 || row_bytes <= 0) return 0;
    if (n_threads < 1) n_threads = 1;
    if (n_threads > 16) n_threads = 16;
    /* not worth thread spawn below ~1 MB of copying */
    if (n_threads == 1 || n_rows * row_bytes < (1 << 20)) {
        gather_task t = {dst, src, idx, 0, n_rows, row_bytes};
        gather_worker(&t);
        return 0;
    }
    pthread_t threads[16];
    gather_task tasks[16];
    int created[16] = {0};
    int64_t chunk = (n_rows + n_threads - 1) / n_threads;
    for (int i = 0; i < n_threads; ++i) {
        int64_t b = (int64_t)i * chunk;
        int64_t e = b + chunk < n_rows ? b + chunk : n_rows;
        if (b >= e) break;
        tasks[i] = (gather_task){dst, src, idx, b, e, row_bytes};
        if (pthread_create(&threads[i], NULL, gather_worker, &tasks[i]) == 0) {
            created[i] = 1;
        } else {
            gather_worker(&tasks[i]);   /* run this chunk inline */
        }
    }
    for (int i = 0; i < n_threads; ++i) {
        if (created[i]) pthread_join(threads[i], NULL);
    }
    return 0;
}
