// Native host-side IQ ingest runtime for rub_mimo_tpu.
//
// Successor of the reference's C++ I/O runtime: UHD's wire/CPU
// format conversion ("sc16" wire, "fc32" cpu — mimo/config.h:51-52), the
// rx_worker capture loop that fwrites raw IQ to disk (mimo/main.cc:872-898)
// and the pthread tx/rx pipeline (main.cc:1373-1386).  Here the radio is a
// file: this library provides
//
//   - vectorized sc16 <-> fc32 IQ conversion (the UHD wire format, so
//     int16 captures replay and new captures can be written compactly)
//   - interleaved <-> planar multichannel deinterleaving
//   - capture validation scans (NaN/Inf, peak magnitude)
//   - a double-buffered background-prefetch block reader (single-writer
//     thread + mutex/condvar, the disciplined version of the reference's
//     rx thread handshake) so host IO overlaps device compute
//   - a live TCP IQ source (the UHD rx_streamer::recv analog,
//     mimo/main.cc:872-877): a background thread accepts one sender and
//     fills the same prefetch ring, so pipeline.streaming consumes a
//     network feed exactly like a file replay
//
// Exposed as a plain C ABI consumed from Python via ctypes
// (rub_mimo_tpu/io/native.py), with a numpy fallback when unbuilt.

#include <atomic>
#include <cerrno>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <netinet/in.h>
#include <poll.h>
#include <sys/socket.h>
#include <unistd.h>

extern "C" {

// ---------------------------------------------------------------------
// format conversion
// ---------------------------------------------------------------------

// Interleaved sc16 IQ -> float32 IQ pairs.  scale maps int16 full scale to
// the desired float amplitude (UHD uses 1/32767).
void rmt_sc16_to_fc32(const int16_t* in, float* out, int64_t n_iq,
                      float scale) {
  const int64_t n = n_iq * 2;
  for (int64_t i = 0; i < n; ++i) out[i] = static_cast<float>(in[i]) * scale;
}

// float32 IQ pairs -> interleaved sc16 with clamping.
void rmt_fc32_to_sc16(const float* in, int16_t* out, int64_t n_iq,
                      float scale) {
  const int64_t n = n_iq * 2;
  for (int64_t i = 0; i < n; ++i) {
    float v = in[i] * scale;
    if (v > 32767.0f) v = 32767.0f;
    if (v < -32768.0f) v = -32768.0f;
    out[i] = static_cast<int16_t>(lrintf(v));
  }
}

// Interleaved multichannel fc32 IQ -> planar [chan][samp] buffers.
void rmt_deinterleave_fc32(const float* in, float** outs, int32_t n_chan,
                           int64_t n_samp) {
  for (int64_t s = 0; s < n_samp; ++s) {
    const float* src = in + 2 * n_chan * s;
    for (int32_t c = 0; c < n_chan; ++c) {
      outs[c][2 * s] = src[2 * c];
      outs[c][2 * s + 1] = src[2 * c + 1];
    }
  }
}

// Planar -> interleaved.
void rmt_interleave_fc32(const float** ins, float* out, int32_t n_chan,
                         int64_t n_samp) {
  for (int64_t s = 0; s < n_samp; ++s) {
    float* dst = out + 2 * n_chan * s;
    for (int32_t c = 0; c < n_chan; ++c) {
      dst[2 * c] = ins[c][2 * s];
      dst[2 * c + 1] = ins[c][2 * s + 1];
    }
  }
}

// ---------------------------------------------------------------------
// validation scans (ingest-layer failure detection; SURVEY §5)
// ---------------------------------------------------------------------

// Returns: 0 ok; 1 non-finite found.  Writes max |re|,|im| to *peak.
int32_t rmt_validate_fc32(const float* in, int64_t n_floats, float* peak) {
  float p = 0.0f;
  int32_t bad = 0;
  for (int64_t i = 0; i < n_floats; ++i) {
    const float v = in[i];
    if (!std::isfinite(v)) bad = 1;
    const float a = std::fabs(v);
    if (a > p) p = a;
  }
  *peak = p;
  return bad;
}

// ---------------------------------------------------------------------
// background-prefetch block reader
// ---------------------------------------------------------------------

// Shared single-producer/single-consumer block ring used by both the file
// prefetcher and the TCP source.
struct RmtRing {
  int64_t block_bytes = 0;
  int n_buffers = 0;
  std::vector<std::vector<uint8_t>> bufs;
  std::vector<int64_t> filled;  // bytes valid in each slot; -1 = empty
  int64_t head = 0;             // next slot to hand out
  int64_t tail = 0;             // next slot to fill
  bool eof = false;
  std::atomic<bool> stop{false};
  std::mutex mu;
  std::condition_variable cv_can_fill, cv_can_read;

  void init(int64_t bb, int nb) {
    block_bytes = bb;
    n_buffers = nb;
    bufs.resize(nb);
    for (auto& b : bufs) b.resize(static_cast<size_t>(bb));
    filled.assign(nb, -1);
  }

  // Producer: block until a slot is free (or stop); -1 on stop.
  int acquire_slot() {
    std::unique_lock<std::mutex> lk(mu);
    cv_can_fill.wait(lk, [&] {
      return stop.load() || (tail - head) < n_buffers;
    });
    if (stop.load()) return -1;
    return static_cast<int>(tail % n_buffers);
  }

  // Producer: publish `got` bytes in the acquired slot; final=true marks
  // end of stream (short block or source closed).
  void commit(int slot, int64_t got, bool final_block) {
    std::lock_guard<std::mutex> lk(mu);
    filled[slot] = got;
    ++tail;
    if (final_block) eof = true;
    cv_can_read.notify_all();
  }

  void finish() {
    std::lock_guard<std::mutex> lk(mu);
    eof = true;
    cv_can_read.notify_all();
  }

  // Consumer: blocking pop; returns bytes copied (0 once drained at EOF
  // or when shut down).
  int64_t pop(uint8_t* out) {
    std::unique_lock<std::mutex> lk(mu);
    cv_can_read.wait(lk, [&] { return head < tail || eof || stop.load(); });
    if (head >= tail) return 0;
    const int slot = static_cast<int>(head % n_buffers);
    const int64_t got = filled[slot];
    memcpy(out, bufs[slot].data(), static_cast<size_t>(got));
    filled[slot] = -1;
    ++head;
    cv_can_fill.notify_one();
    return got;
  }

  void shutdown() {
    stop.store(true);
    cv_can_fill.notify_all();
    cv_can_read.notify_all();
  }
};

struct RmtReader {
  FILE* f = nullptr;
  RmtRing ring;
  std::thread worker;

  void run() {
    for (;;) {
      const int slot = ring.acquire_slot();
      if (slot < 0) return;
      const size_t got = fread(ring.bufs[slot].data(), 1,
                               static_cast<size_t>(ring.block_bytes), f);
      const bool final_block = got < static_cast<size_t>(ring.block_bytes);
      ring.commit(slot, static_cast<int64_t>(got), final_block);
      if (final_block) return;
    }
  }
};

// Open a capture for background-prefetched block reads.
void* rmt_reader_open(const char* path, int64_t block_bytes,
                      int32_t n_buffers) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  auto* r = new RmtReader();
  r->f = f;
  r->ring.init(block_bytes, n_buffers);
  r->worker = std::thread([r] { r->run(); });
  return r;
}

// Blocking: copy the next block into out; returns bytes copied (0 at EOF).
int64_t rmt_reader_next(void* handle, uint8_t* out) {
  return static_cast<RmtReader*>(handle)->ring.pop(out);
}

void rmt_reader_close(void* handle) {
  auto* r = static_cast<RmtReader*>(handle);
  r->ring.shutdown();
  if (r->worker.joinable()) r->worker.join();
  fclose(r->f);
  delete r;
}

// ---------------------------------------------------------------------
// live TCP IQ source (UHD rx_streamer::recv analog)
// ---------------------------------------------------------------------

struct RmtSocket {
  int listen_fd = -1;
  int conn_fd = -1;
  int32_t port = 0;
  RmtRing ring;
  std::thread worker;

  // poll an fd for readability every 100 ms while honouring stop.
  // EINTR is retried (signals hitting the worker thread are routine);
  // any other poll() failure reports unreadable so run() can terminate
  // the stream cleanly instead of leaving the consumer blocked.
  bool wait_readable(int fd) {
    struct pollfd p;
    p.fd = fd;
    p.events = POLLIN;
    while (!ring.stop.load()) {
      p.revents = 0;
      const int rc = poll(&p, 1, 100);
      if (rc > 0 && (p.revents & (POLLIN | POLLHUP))) return true;
      if (rc < 0 && errno != EINTR) return false;
    }
    return false;
  }

  void run() {
    if (!wait_readable(listen_fd)) {
      ring.finish();
      return;
    }
    conn_fd = accept(listen_fd, nullptr, nullptr);
    if (conn_fd < 0) {
      ring.finish();
      return;
    }
    for (;;) {
      const int slot = ring.acquire_slot();
      if (slot < 0) return;  // stop requested: consumer initiated shutdown
      int64_t got = 0;
      bool closed = false;
      while (got < ring.block_bytes) {
        if (!wait_readable(conn_fd)) {
          // poll failure or stop: publish the partial block as final so a
          // blocked consumer wakes with EOF instead of hanging forever.
          closed = true;
          break;
        }
        const ssize_t n =
            recv(conn_fd, ring.bufs[slot].data() + got,
                 static_cast<size_t>(ring.block_bytes - got), 0);
        if (n <= 0) {  // peer closed (0) or error (<0)
          closed = true;
          break;
        }
        got += n;
      }
      ring.commit(slot, got, closed);
      if (closed) return;
    }
  }
};

// Bind 127.0.0.1:port (port 0 auto-assigns; read back with
// rmt_socket_port), listen for ONE sender, prefetch its blocks.
void* rmt_socket_open(int32_t port, int64_t block_bytes,
                      int32_t n_buffers) {
  const int fd = socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  struct sockaddr_in addr;
  memset(&addr, 0, sizeof(addr));
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (bind(fd, reinterpret_cast<struct sockaddr*>(&addr), sizeof(addr)) <
          0 ||
      listen(fd, 1) < 0) {
    close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<struct sockaddr*>(&addr), &alen);
  auto* s = new RmtSocket();
  s->listen_fd = fd;
  s->port = static_cast<int32_t>(ntohs(addr.sin_port));
  s->ring.init(block_bytes, n_buffers);
  s->worker = std::thread([s] { s->run(); });
  return s;
}

int32_t rmt_socket_port(void* handle) {
  return static_cast<RmtSocket*>(handle)->port;
}

int64_t rmt_socket_next(void* handle, uint8_t* out) {
  return static_cast<RmtSocket*>(handle)->ring.pop(out);
}

void rmt_socket_close(void* handle) {
  auto* s = static_cast<RmtSocket*>(handle);
  s->ring.shutdown();
  if (s->worker.joinable()) s->worker.join();
  if (s->conn_fd >= 0) close(s->conn_fd);
  if (s->listen_fd >= 0) close(s->listen_fd);
  delete s;
}

}  // extern "C"
