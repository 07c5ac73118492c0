// ThreadSanitizer stress harness for the native ring (race-detection
// discipline ≈ the reference's -DTHREAD_SANITIZER CI option, README.md:107 and
// qa_buffer.cpp concurrency stress). Build + run under TSAN:
//
//   g++ -O1 -g -fsanitize=thread -std=c++20 ring_stress.cpp ringbuf.cpp \
//       -o ring_stress && ./ring_stress
//
// Exercises, concurrently: single-producer reserve/publish, multi-producer
// CAS claims with ticket-ordered publish, multiple readers with independent
// cursors, reader registration racing a live producer, and the
// futex-parked blocking waits. Exit 0 = all data accounted
// for; TSAN reports any data race as a hard failure.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {
struct Ring;
Ring* gr4_ring_create(std::size_t min_capacity);
void gr4_ring_destroy(Ring* r);
std::size_t gr4_ring_capacity(Ring* r);
int gr4_ring_add_reader(Ring* r);
std::uint8_t* gr4_ring_reserve(Ring* r, std::size_t n, std::size_t* avail);
void gr4_ring_publish(Ring* r, std::size_t n);
std::uint8_t* gr4_ring_read(Ring* r, int reader, std::size_t max_n, std::size_t* avail);
void gr4_ring_release(Ring* r, int reader, std::size_t n);
std::size_t gr4_ring_readable(Ring* r, int reader);
void gr4_ring_set_eos(Ring* r);
int gr4_ring_eos(Ring* r);
std::uint8_t* gr4_ring_reserve_mp(Ring* r, std::size_t n, std::size_t* avail, std::uint64_t* ticket);
void gr4_ring_publish_mp(Ring* r, std::uint64_t ticket, std::size_t n);
int gr4_ring_wait_readable(Ring* r, int reader, std::size_t min_bytes, long timeout_us);
int gr4_ring_wait_writable(Ring* r, std::size_t min_bytes, long timeout_us);
}

namespace {

constexpr std::size_t kTotal = 1 << 20;   // bytes pushed per scenario

int spsc_with_blocking_reader() {
    Ring* r = gr4_ring_create(1 << 14);
    const int rd = gr4_ring_add_reader(r);
    std::atomic<std::uint64_t> sum_in{0}, sum_out{0};

    std::thread producer([&] {
        std::uint8_t v = 0;
        std::size_t sent = 0;
        while (sent < kTotal) {
            std::size_t avail = 0;
            std::uint8_t* p = gr4_ring_reserve(r, 4096, &avail);
            if (!p) {
                gr4_ring_wait_writable(r, 1, 1000000);
                continue;
            }
            for (std::size_t i = 0; i < avail; i++) {
                p[i] = v;
                sum_in.fetch_add(v, std::memory_order_relaxed);
                ++v;
            }
            gr4_ring_publish(r, avail);
            sent += avail;
        }
        gr4_ring_set_eos(r);
    });
    std::thread consumer([&] {
        std::size_t got = 0;
        while (got < kTotal) {
            if (gr4_ring_wait_readable(r, rd, 1, 1000000) == 0 &&
                gr4_ring_readable(r, rd) == 0) {
                break;
            }
            std::size_t avail = 0;
            std::uint8_t* p = gr4_ring_read(r, rd, 0, &avail);
            if (!p) {
                continue;
            }
            for (std::size_t i = 0; i < avail; i++) {
                sum_out.fetch_add(p[i], std::memory_order_relaxed);
            }
            gr4_ring_release(r, rd, avail);
            got += avail;
        }
    });
    producer.join();
    consumer.join();
    const bool ok = sum_in.load() == sum_out.load();
    gr4_ring_destroy(r);
    if (!ok) {
        std::fprintf(stderr, "spsc checksum mismatch\n");
    }
    return ok ? 0 : 1;
}

int mpsc_with_late_readers() {
    Ring* r = gr4_ring_create(1 << 14);
    const int rd0 = gr4_ring_add_reader(r);
    std::atomic<std::uint64_t> bytes_in{0}, bytes_out{0};
    std::atomic<bool> done{0};

    constexpr int kProducers = 4;
    std::vector<std::thread> producers;
    for (int t = 0; t < kProducers; t++) {
        producers.emplace_back([&, t] {
            std::size_t sent = 0;
            while (sent < kTotal / kProducers) {
                std::size_t avail = 0;
                std::uint64_t ticket = 0;
                std::uint8_t* p = gr4_ring_reserve_mp(r, 512, &avail, &ticket);
                if (!p) {
                    gr4_ring_wait_writable(r, 1, 1000000);
                    continue;
                }
                std::memset(p, t + 1, avail);
                gr4_ring_publish_mp(r, ticket, avail);
                bytes_in.fetch_add(avail, std::memory_order_relaxed);
                sent += avail;
            }
        });
    }
    // late reader registration racing live producers: a half-registered
    // reader must never make free-space underflow
    std::thread late([&] {
        const int rd = gr4_ring_add_reader(r);   // registration races writers
        if (rd < 0) {
            return;
        }
        // keep draining until the run ends — a stalled reader cursor would
        // deadlock the producers (min_tail gates their free space)
        while (!done.load(std::memory_order_acquire)) {
            std::size_t avail = 0;
            std::uint8_t* p = gr4_ring_read(r, rd, 0, &avail);
            if (p) {
                gr4_ring_release(r, rd, avail);
            } else {
                gr4_ring_wait_readable(r, rd, 1, 10000);
            }
        }
    });
    std::thread consumer([&] {
        while (bytes_out.load() < kTotal) {
            if (gr4_ring_wait_readable(r, rd0, 1, 2000000) < 0) {
                break;
            }
            std::size_t avail = 0;
            std::uint8_t* p = gr4_ring_read(r, rd0, 0, &avail);
            if (!p) {
                continue;
            }
            for (std::size_t i = 0; i < avail; i++) {
                if (p[i] < 1 || p[i] > kProducers) {
                    std::fprintf(stderr, "mpsc corrupt byte %d\n", p[i]);
                    _Exit(2);
                }
            }
            gr4_ring_release(r, rd0, avail);
            bytes_out.fetch_add(avail, std::memory_order_relaxed);
        }
    });
    for (auto& t : producers) {
        t.join();
    }
    consumer.join();
    done.store(true);
    gr4_ring_set_eos(r);
    late.join();
    const bool ok = bytes_out.load() == kTotal;
    gr4_ring_destroy(r);
    if (!ok) {
        std::fprintf(stderr, "mpsc byte count %llu != %zu\n",
                     (unsigned long long)bytes_out.load(), kTotal);
    }
    return ok ? 0 : 1;
}

} // namespace

int main() {
    if (int rc = spsc_with_blocking_reader(); rc != 0) {
        return rc;
    }
    if (int rc = mpsc_with_late_readers(); rc != 0) {
        return rc;
    }
    std::puts("ring_stress OK");
    return 0;
}
