// Native data-plane TCP streamer.
//
// C++ equivalent of the reference Sync_server hot path
// (cpp/USRP_server_network.cpp:195-308): a dedicated thread pops serialized
// RX_wrapper packets (21-byte header + complex64 payload, already framed by
// the caller) from a lock-free ring and streams them to one connected
// client, surviving disconnect/reconnect.  Exposed as a C API for ctypes.
//
// Build: cmake -S native -B native/build && cmake --build native/build

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstdio>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>

#include "spsc_ring.hpp"

namespace {

using gpu_sdr::SpscRing;

struct StreamServer {
  int listen_fd = -1;
  int client_fd = -1;
  std::mutex fd_mu;   // guards client_fd open/close/shutdown across threads
  std::atomic<bool> drop_requested{false};
  int port = 0;
  std::unique_ptr<SpscRing> ring;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> packets_sent{0};
  std::atomic<uint64_t> bytes_sent{0};

  ~StreamServer() { shutdown(); }

  bool listen_on(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons(static_cast<uint16_t>(want_port));
    if (::bind(listen_fd, reinterpret_cast<sockaddr*>(&addr),
               sizeof(addr)) < 0)
      return false;
    if (::listen(listen_fd, 1) < 0) return false;
    socklen_t len = sizeof(addr);
    ::getsockname(listen_fd, reinterpret_cast<sockaddr*>(&addr), &len);
    port = ntohs(addr.sin_port);
    // non-blocking accepts via timeout
    timeval tv{0, 200000};
    ::setsockopt(listen_fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    return true;
  }

  void try_accept() {
    fd_set rfds;
    FD_ZERO(&rfds);
    FD_SET(listen_fd, &rfds);
    timeval tv{0, 200000};
    if (::select(listen_fd + 1, &rfds, nullptr, nullptr, &tv) <= 0) return;
    int c = ::accept(listen_fd, nullptr, nullptr);
    if (c >= 0) {
      int one = 1;
      ::setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
      std::lock_guard<std::mutex> g(fd_mu);
      client_fd = c;
      // a drop flagged against the PREVIOUS client must not evict the
      // client we just accepted
      drop_requested.store(false, std::memory_order_release);
    }
  }

  bool send_all(const uint8_t* data, std::size_t len) {
    std::size_t sent = 0;
    while (sent < len) {
      ssize_t n = ::send(client_fd, data + sent, len - sent, MSG_NOSIGNAL);
      if (n <= 0) return false;
      sent += static_cast<std::size_t>(n);
    }
    return true;
  }

  void close_client() {
    std::lock_guard<std::mutex> g(fd_mu);
    if (client_fd >= 0) {
      ::close(client_fd);
      client_fd = -1;
    }
  }

  // Safe from any thread: shut the socket down (unblocking a send that is
  // stalled on a full TCP buffer) but leave close() to the worker, which
  // owns the fd lifecycle.
  void request_drop() {
    drop_requested.store(true, std::memory_order_release);
    std::lock_guard<std::mutex> g(fd_mu);
    if (client_fd >= 0) ::shutdown(client_fd, SHUT_RDWR);
  }

  void run() {
    while (!stop.load(std::memory_order_acquire)) {
      // command-plane-initiated drop (reference reconnect_data flag):
      // close the stale client so the returning one can be accepted
      if (drop_requested.exchange(false, std::memory_order_acq_rel)) {
        close_client();
      }
      if (client_fd < 0) {
        try_accept();
        continue;
      }
      std::size_t len = 0;
      const uint8_t* slot = ring->front(&len);
      if (slot == nullptr) {
        std::this_thread::sleep_for(std::chrono::microseconds(100));
        continue;
      }
      if (!send_all(slot, len)) {  // client went away; keep packet? drop
        close_client();
        continue;  // packet retained in ring for the reconnected client
      }
      packets_sent.fetch_add(1, std::memory_order_relaxed);
      bytes_sent.fetch_add(len, std::memory_order_relaxed);
      ring->pop();
    }
  }

  void shutdown() {
    stop.store(true, std::memory_order_release);
    {
      // unblock a send stalled on an unresponsive client so join() can't
      // hang for the kernel TCP timeout
      std::lock_guard<std::mutex> g(fd_mu);
      if (client_fd >= 0) ::shutdown(client_fd, SHUT_RDWR);
    }
    if (worker.joinable()) worker.join();
    if (client_fd >= 0) ::close(client_fd);
    if (listen_fd >= 0) ::close(listen_fd);
    client_fd = listen_fd = -1;
  }
};

}  // namespace

extern "C" {

void* sdr_stream_server_create(int port, std::size_t slot_bytes,
                               std::size_t n_slots) {
  auto* s = new StreamServer();
  s->ring = std::make_unique<SpscRing>(slot_bytes, n_slots);
  if (!s->listen_on(port)) {
    delete s;
    return nullptr;
  }
  s->worker = std::thread([s] { s->run(); });
  return s;
}

int sdr_stream_server_port(void* handle) {
  return static_cast<StreamServer*>(handle)->port;
}

// Push one fully framed packet; returns 1 on success, 0 when the ring is
// full (caller may retry).
int sdr_stream_server_push(void* handle, const uint8_t* data,
                           std::size_t len) {
  return static_cast<StreamServer*>(handle)->ring->push(data, len) ? 1 : 0;
}

int sdr_stream_server_pending(void* handle) {
  return static_cast<int>(static_cast<StreamServer*>(handle)->ring->size());
}

unsigned long long sdr_stream_server_packets_sent(void* handle) {
  return static_cast<StreamServer*>(handle)->packets_sent.load();
}

unsigned long long sdr_stream_server_bytes_sent(void* handle) {
  return static_cast<StreamServer*>(handle)->bytes_sent.load();
}

int sdr_stream_server_connected(void* handle) {
  return static_cast<StreamServer*>(handle)->client_fd >= 0 ? 1 : 0;
}

// Request the worker to close the current client (safe from any thread);
// the next accept serves the reconnecting client.
void sdr_stream_server_drop_client(void* handle) {
  if (handle == nullptr) return;
  static_cast<StreamServer*>(handle)->request_drop();
}

void sdr_stream_server_destroy(void* handle) {
  delete static_cast<StreamServer*>(handle);
}

}  // extern "C"
