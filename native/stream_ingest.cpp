// Native data-plane TCP ingest receiver.
//
// C++ equivalent of the reference RX hardware thread
// (single_rx_thread, cpp/USRP_hardware_manager.cpp:1398-1611): a dedicated
// thread recv()s a raw complex64 IQ byte stream from one connected producer
// (the radio / DMA bridge stand-in), reassembles it into fixed-size blocks
// (the reference's fragmentation handling, :1546-1560), and hands the blocks
// to the Python/JAX pipeline through a lock-free SPSC ring (the reference's
// pinned-pool + rx_queue).  Ring-full drops are counted like UHD overflow
// errors and ride the RX_wrapper.errors field.  Exposed as a C API for
// ctypes.

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/select.h>
#include <unistd.h>

#include <atomic>
#include <chrono>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#include "spsc_ring.hpp"

namespace {

using gpu_sdr::SpscRing;

struct IngestServer {
  int listen_fd = -1;
  int client_fd = -1;
  int port = 0;
  std::size_t block_bytes = 0;
  std::unique_ptr<SpscRing> ring;
  std::vector<uint8_t> staging;
  std::thread worker;
  std::atomic<bool> stop{false};
  std::atomic<uint64_t> blocks_received{0};
  std::atomic<uint64_t> overflows{0};   // ring full -> block dropped
  std::atomic<uint64_t> fragments{0};   // recv() calls (frag diagnostics)
  std::atomic<uint64_t> padded{0};      // zero-filled samples in the
                                        // delivered EOF tail block
  std::atomic<bool> eof{false};         // producer closed; stream is over

  ~IngestServer() { shutdown(); }

  bool listen_on(int want_port) {
    listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
    if (listen_fd < 0) return false;
    int one = 1;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
    // deep kernel buffer, set on the LISTENING socket: the TCP window
    // scale factor is negotiated at SYN time from this socket's buffer,
    // so setting it only on the accepted fd (post-handshake) caps the
    // advertised window below the 8 MB intent; accepted
    // sockets inherit it
    int buf = 8 * 1024 * 1024;
    ::setsockopt(listen_fd, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
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
      // deep kernel buffer inherited from the listening socket (set
      // there so the window scale covers it); re-assert for safety —
      // rides bursts through consumer stalls (the role of the
      // reference's NIC ring tuning, tools/ubuntu_lan_config)
      int buf = 8 * 1024 * 1024;
      ::setsockopt(c, SOL_SOCKET, SO_RCVBUF, &buf, sizeof(buf));
      client_fd = c;
      eof.store(false, std::memory_order_release);
    }
  }

  // Fill the staging buffer with exactly block_bytes (or return false on
  // EOF/stop).  A partial tail block at EOF is zero-padded and delivered.
  bool recv_block() {
    std::size_t got = 0;
    while (got < block_bytes) {
      if (stop.load(std::memory_order_acquire)) return false;
      ssize_t n = ::recv(client_fd, staging.data() + got,
                         block_bytes - got, 0);
      if (n <= 0) {  // producer went away
        if (got > 0) {  // deliver the zero-padded tail first, with the
          // missing samples counted so the packet is error-stamped
          // (reference get_rx_errors accounting,
          // cpp/USRP_server_diagnostic.cpp:14-106)
          std::memset(staging.data() + got, 0, block_bytes - got);
          padded.fetch_add((block_bytes - got) / 8,
                           std::memory_order_relaxed);
          got = block_bytes;
          break;
        }
        return false;
      }
      got += static_cast<std::size_t>(n);
      fragments.fetch_add(1, std::memory_order_relaxed);
    }
    return true;
  }

  void run() {
    while (!stop.load(std::memory_order_acquire)) {
      if (client_fd < 0) {
        try_accept();
        continue;
      }
      if (!recv_block()) {
        ::close(client_fd);
        client_fd = -1;
        eof.store(true, std::memory_order_release);
        continue;  // allow a new producer to connect
      }
      if (ring->push(staging.data(), block_bytes)) {
        blocks_received.fetch_add(1, std::memory_order_relaxed);
      } else {
        // consumer is behind: drop the block, count it like a UHD
        // overflow (reference interptet_rx_error 'O')
        overflows.fetch_add(1, std::memory_order_relaxed);
      }
    }
  }

  void shutdown() {
    stop.store(true, std::memory_order_release);
    if (client_fd >= 0) ::shutdown(client_fd, SHUT_RDWR);
    if (worker.joinable()) worker.join();
    if (client_fd >= 0) ::close(client_fd);
    if (listen_fd >= 0) ::close(listen_fd);
    client_fd = listen_fd = -1;
  }
};

}  // namespace

extern "C" {

void* sdr_ingest_create(int port, std::size_t block_bytes,
                        std::size_t n_slots) {
  auto* s = new IngestServer();
  s->block_bytes = block_bytes;
  s->ring = std::make_unique<SpscRing>(block_bytes, n_slots);
  s->staging.resize(block_bytes);
  if (!s->listen_on(port)) {
    delete s;
    return nullptr;
  }
  s->worker = std::thread([s] { s->run(); });
  return s;
}

int sdr_ingest_port(void* handle) {
  return static_cast<IngestServer*>(handle)->port;
}

// Pop one block into dst (block_bytes long); returns 1 on success, 0 when
// the ring is empty (non-blocking; caller polls).
int sdr_ingest_pop(void* handle, uint8_t* dst) {
  auto* s = static_cast<IngestServer*>(handle);
  std::size_t len = 0;
  const uint8_t* slot = s->ring->front(&len);
  if (slot == nullptr) return 0;
  std::memcpy(dst, slot, len);
  s->ring->pop();
  return 1;
}

int sdr_ingest_pending(void* handle) {
  return static_cast<int>(static_cast<IngestServer*>(handle)->ring->size());
}

int sdr_ingest_connected(void* handle) {
  return static_cast<IngestServer*>(handle)->client_fd >= 0 ? 1 : 0;
}

// Producer closed the connection and the ring may still hold blocks.
int sdr_ingest_eof(void* handle) {
  return static_cast<IngestServer*>(handle)->eof.load() ? 1 : 0;
}

unsigned long long sdr_ingest_blocks_received(void* handle) {
  return static_cast<IngestServer*>(handle)->blocks_received.load();
}

unsigned long long sdr_ingest_overflows(void* handle) {
  return static_cast<IngestServer*>(handle)->overflows.load();
}

unsigned long long sdr_ingest_fragments(void* handle) {
  return static_cast<IngestServer*>(handle)->fragments.load();
}

unsigned long long sdr_ingest_padded(void* handle) {
  return static_cast<IngestServer*>(handle)->padded.load();
}

void sdr_ingest_destroy(void* handle) {
  delete static_cast<IngestServer*>(handle);
}

}  // extern "C"
