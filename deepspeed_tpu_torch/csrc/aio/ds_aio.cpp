// Async file I/O for the NVMe swap of the PyTorch port.
//
// The port's own copy of the JAX package's host library (csrc/aio/ds_aio.cpp
// there), itself the counterpart of the reference's libaio-based csrc/aio: a
// pthread pool issues positional pread/pwrite in block_size chunks across
// the file. A request whose buffer address, length and offset are all
// multiples of kDirectAlign opens the file with O_DIRECT, so NVMe bandwidth
// is not throttled by the page cache; if the filesystem refuses O_DIRECT the
// request is opened buffered, and a chunk that O_DIRECT refuses is retried
// on a buffered descriptor. The handle counts the chunks and bytes that went
// around the page cache and those that went through it (aio_counts), so a
// caller can tell a disk's rate from the page cache's. A plain C ABI bound with ctypes from
// deepspeed_tpu_torch/ops/aio.py; buffers are torch CPU tensors (pinned or
// not) passed by address.
//
// Each request is split into chunks on a shared queue; workers pull until
// it drains; aio_wait() blocks until everything submitted so far is done and
// returns the number of chunks that failed. A chunk fails when a read or
// write returns an error, or when a read meets the end of the file before
// its length (a swap file that reads short is an error, never zeros).
//
// Changes from the JAX copy: 4096-byte alignment for O_DIRECT (the logical
// block of NVMe drives; 512 passes the check and then fails on such
// devices), and end of file counted as a failure before the buffered retry.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <fcntl.h>
#include <memory>
#include <mutex>
#include <string>
#include <sys/stat.h>
#include <sys/types.h>
#include <thread>
#include <unistd.h>
#include <vector>

namespace {

constexpr size_t kDirectAlign = 4096;

struct Request {
    int fd = -1;
    std::string path;
    int buffered_flags = 0;        // flags for the buffered retry
    bool direct = false;
    std::atomic<int> fallback_fd{-1};
    std::mutex reopen_mu;
    ~Request() {
        if (fd >= 0) close(fd);
        int ffd = fallback_fd.load();
        if (ffd >= 0) close(ffd);
    }
    // An O_DIRECT open can succeed and a transfer on it still fail (EINVAL
    // on a filesystem that checks alignment per call): open one buffered
    // descriptor for the request and retry there.
    int get_fallback() {
        int ffd = fallback_fd.load();
        if (ffd >= 0) return ffd;
        std::lock_guard<std::mutex> lk(reopen_mu);
        ffd = fallback_fd.load();
        if (ffd >= 0) return ffd;
        ffd = open(path.c_str(), buffered_flags, 0644);
        fallback_fd.store(ffd);
        return ffd;
    }
};

struct Task {
    std::shared_ptr<Request> req;
    char* buf;
    size_t nbytes;
    off_t offset;
    bool is_write;
};

struct Handle {
    size_t block_size;
    bool use_direct;
    std::vector<std::thread> workers;
    std::deque<Task> queue;
    std::mutex mu;
    std::condition_variable cv_work;   // workers wait for tasks
    std::condition_variable cv_done;   // aio_wait waits for the drain
    size_t inflight = 0;               // queued and running chunks
    std::atomic<long> total_errors{0};
    // completed chunks and their bytes: on an O_DIRECT descriptor, and
    // buffered (opened so, or retried so)
    std::atomic<long> direct_chunks{0}, buffered_chunks{0};
    std::atomic<long> direct_bytes{0}, buffered_bytes{0};
    bool shutting_down = false;

    Handle(int n_threads, size_t block, bool direct) : block_size(block), use_direct(direct) {
        for (int i = 0; i < n_threads; ++i) workers.emplace_back([this] { worker_loop(); });
    }

    ~Handle() {
        {
            std::lock_guard<std::mutex> lk(mu);
            shutting_down = true;
        }
        cv_work.notify_all();
        for (auto& t : workers) t.join();
    }

    void worker_loop() {
        for (;;) {
            Task task;
            {
                std::unique_lock<std::mutex> lk(mu);
                cv_work.wait(lk, [this] { return shutting_down || !queue.empty(); });
                if (queue.empty()) return;      // shutting down
                task = std::move(queue.front());
                queue.pop_front();
            }
            if (!run(task)) total_errors.fetch_add(1);
            {
                std::lock_guard<std::mutex> lk(mu);
                if (--inflight == 0) cv_done.notify_all();
            }
        }
    }

    // One chunk; false when it failed.
    bool run(Task& t) {
        size_t done = 0;
        int fd = t.req->fd;
        bool direct = t.req->direct;
        while (done < t.nbytes) {
            ssize_t n = t.is_write
                ? pwrite(fd, t.buf + done, t.nbytes - done, t.offset + done)
                : pread(fd, t.buf + done, t.nbytes - done, t.offset + done);
            if (n == 0) return false;           // end of file before the length
            if (n < 0) {
                if (t.req->direct && fd == t.req->fd) {
                    int ffd = t.req->get_fallback();
                    if (ffd >= 0) {
                        fd = ffd;
                        direct = false;
                        continue;
                    }
                }
                return false;
            }
            done += static_cast<size_t>(n);
        }
        (direct ? direct_chunks : buffered_chunks).fetch_add(1);
        (direct ? direct_bytes : buffered_bytes).fetch_add(static_cast<long>(t.nbytes));
        return true;
    }

    // Split [0, nbytes) into block_size chunks and queue them; the number
    // of chunks, or -1 when the file cannot be opened.
    long submit(const char* path, char* buf, size_t nbytes, off_t offset, bool is_write) {
        bool aligned = use_direct && reinterpret_cast<uintptr_t>(buf) % kDirectAlign == 0 &&
                       nbytes % kDirectAlign == 0 &&
                       static_cast<size_t>(offset) % kDirectAlign == 0;
        int flags = is_write ? (O_WRONLY | O_CREAT) : O_RDONLY;
        int fd = -1;
        bool direct = false;
        if (aligned) {
            fd = open(path, flags | O_DIRECT, 0644);
            direct = fd >= 0;
        }
        if (fd < 0) fd = open(path, flags, 0644);
        if (fd < 0) return -1;

        auto req = std::make_shared<Request>();
        req->fd = fd;
        req->path = path;
        req->buffered_flags = flags;
        req->direct = direct;
        size_t n_chunks = nbytes == 0 ? 0 : (nbytes + block_size - 1) / block_size;
        {
            std::lock_guard<std::mutex> lk(mu);
            for (size_t c = 0; c < n_chunks; ++c) {
                size_t off = c * block_size;
                size_t len = nbytes - off < block_size ? nbytes - off : block_size;
                queue.push_back(Task{req, buf + off, len, offset + static_cast<off_t>(off),
                                     is_write});
                ++inflight;
            }
        }
        cv_work.notify_all();
        return static_cast<long>(n_chunks);
    }

    long wait_all() {
        std::unique_lock<std::mutex> lk(mu);
        cv_done.wait(lk, [this] { return inflight == 0; });
        return total_errors.exchange(0);
    }
};

}  // namespace

extern "C" {

void* aio_handle_new(int n_threads, size_t block_size, int use_direct) {
    if (n_threads <= 0) n_threads = 1;
    if (block_size == 0) block_size = 1 << 20;
    return new Handle(n_threads, block_size, use_direct != 0);
}

void aio_handle_free(void* h) { delete static_cast<Handle*>(h); }

// Queue a read or a write: the number of chunks queued, or -1 when the file
// cannot be opened.
long aio_pread(void* h, const char* path, void* buf, size_t nbytes, size_t offset) {
    return static_cast<Handle*>(h)->submit(path, static_cast<char*>(buf), nbytes,
                                           static_cast<off_t>(offset), false);
}

long aio_pwrite(void* h, const char* path, const void* buf, size_t nbytes, size_t offset) {
    return static_cast<Handle*>(h)->submit(
        path, const_cast<char*>(static_cast<const char*>(buf)), nbytes,
        static_cast<off_t>(offset), true);
}

// Block until every queued chunk is done; the number that failed.
long aio_wait(void* h) { return static_cast<Handle*>(h)->wait_all(); }

// Queue and wait: the number of chunks, -1 when the file cannot be opened,
// -2 when a chunk of this or an earlier request failed.
long aio_sync_pread(void* h, const char* path, void* buf, size_t nbytes, size_t offset) {
    long r = aio_pread(h, path, buf, nbytes, offset);
    if (r < 0) return r;
    return aio_wait(h) == 0 ? r : -2;
}

long aio_sync_pwrite(void* h, const char* path, const void* buf, size_t nbytes,
                     size_t offset) {
    long r = aio_pwrite(h, path, buf, nbytes, offset);
    if (r < 0) return r;
    return aio_wait(h) == 0 ? r : -2;
}

// The completed chunks and bytes so far: out[0] direct chunks, out[1]
// buffered chunks, out[2] direct bytes, out[3] buffered bytes.
void aio_counts(void* h, long* out) {
    auto* hd = static_cast<Handle*>(h);
    out[0] = hd->direct_chunks.load();
    out[1] = hd->buffered_chunks.load();
    out[2] = hd->direct_bytes.load();
    out[3] = hd->buffered_bytes.load();
}

long aio_file_size(const char* path) {
    struct stat st;
    if (stat(path, &st) != 0) return -1;
    return static_cast<long>(st.st_size);
}

}  // extern "C"
