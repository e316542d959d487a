// Smoke test of the SPSC ring: producer and consumer threads exchange
// 1e6 packets; verifies ordering and content integrity.

#include <cassert>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include "spsc_ring.hpp"

int main() {
  gpu_sdr::SpscRing ring(64, 1024);
  constexpr int N = 1000000;

  std::thread producer([&] {
    uint8_t buf[64];
    for (int i = 0; i < N;) {
      std::memcpy(buf, &i, sizeof(i));
      if (ring.push(buf, sizeof(i))) ++i;
    }
  });

  int expected = 0;
  while (expected < N) {
    std::size_t len = 0;
    const uint8_t* p = ring.front(&len);
    if (p == nullptr) continue;
    int got;
    std::memcpy(&got, p, sizeof(got));
    assert(len == sizeof(int));
    assert(got == expected);
    ring.pop();
    ++expected;
  }
  producer.join();

  // oversized packets grow their slot instead of being rejected (the
  // legal packet range spans 120x, so slots size on demand)
  std::vector<uint8_t> big(4096, 0xAB);
  assert(ring.push(big.data(), big.size()));
  std::size_t len = 0;
  const uint8_t* p = ring.front(&len);
  assert(p != nullptr && len == big.size());
  assert(std::memcmp(p, big.data(), big.size()) == 0);
  ring.pop();

  std::printf("ring_test OK: %d packets in order\n", N);
  return 0;
}
