// Lock-free single-producer/single-consumer ring buffer of byte slots.
//
// Native equivalent of the reference's preallocator pinned-buffer pools and
// boost::lockfree queues (headers/USRP_server_memory_management.hpp:103-273,
// headers/USRP_server_settings.hpp:230-232): fixed-size slots are recycled
// between a producer (the Python/JAX pipeline pushing packets) and a
// consumer (the TCP streamer thread) without locks in the hot path.

#pragma once

#include <atomic>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace gpu_sdr {

class SpscRing {
 public:
  // slot_bytes is the INITIAL per-slot capacity: a push larger than the
  // current capacity grows that slot (amortized; only the producer
  // touches an unpublished slot, so growth is SPSC-safe).  The legal
  // packet range spans 50k..6M samples (MIN/MAX_USEFULL_BUFFER), a 120x
  // spread -- preallocating the maximum for every slot would cost
  // slots*48MB, so slots grow on demand instead of rejecting/dropping
  // oversized packets.
  SpscRing(std::size_t slot_bytes, std::size_t n_slots)
      : slot_bytes_(slot_bytes),
        n_slots_(n_slots),
        lengths_(n_slots, 0),
        slots_(n_slots),
        head_(0),
        tail_(0) {
    for (auto& s : slots_) s.resize(slot_bytes);
  }

  std::size_t slot_bytes() const { return slot_bytes_; }

  // Producer: copy `len` bytes in; returns false when full (non-blocking).
  bool push(const uint8_t* data, std::size_t len) {
    const std::size_t head = head_.load(std::memory_order_relaxed);
    const std::size_t next = (head + 1) % n_slots_;
    if (next == tail_.load(std::memory_order_acquire)) return false;  // full
    if (slots_[head].size() < len) slots_[head].resize(len);
    std::memcpy(slots_[head].data(), data, len);
    lengths_[head] = len;
    head_.store(next, std::memory_order_release);
    return true;
  }

  // Consumer: peek the next filled slot; returns nullptr when empty.
  const uint8_t* front(std::size_t* len) {
    const std::size_t tail = tail_.load(std::memory_order_relaxed);
    if (tail == head_.load(std::memory_order_acquire)) return nullptr;
    *len = lengths_[tail];
    return slots_[tail].data();
  }

  // Consumer: release the slot returned by front().
  void pop() {
    const std::size_t tail = tail_.load(std::memory_order_relaxed);
    tail_.store((tail + 1) % n_slots_, std::memory_order_release);
  }

  bool empty() const {
    return tail_.load(std::memory_order_acquire) ==
           head_.load(std::memory_order_acquire);
  }

  std::size_t size() const {
    const std::size_t h = head_.load(std::memory_order_acquire);
    const std::size_t t = tail_.load(std::memory_order_acquire);
    return (h + n_slots_ - t) % n_slots_;
  }

 private:
  const std::size_t slot_bytes_;
  const std::size_t n_slots_;
  std::vector<std::size_t> lengths_;
  std::vector<std::vector<uint8_t>> slots_;
  std::atomic<std::size_t> head_;  // producer writes
  std::atomic<std::size_t> tail_;  // consumer writes
};

}  // namespace gpu_sdr
