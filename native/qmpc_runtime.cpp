// qmpc_runtime — native host-side runtime for the quaternion-MPC stack.
//
// Role parity with the reference's C++ runtime layer:
//  - RateLoop: absolute-deadline periodic executor with optional SCHED_FIFO,
//    replacing the sleep-to-period loops of legged_ctrl/src/Main.cpp:88-207
//    (MPC 5 ms / low-level 0.25 ms / feedback 1 ms) with clock_nanosleep
//    TIMER_ABSTIME (no drift) and jitter accounting.
//  - StateBus: wait-free single-writer seqlock snapshot exchange, replacing
//    the one global std::mutex the reference shares across threads
//    (Main.cpp:22; intentionally skipped by the 4 kHz loop at :137-139 —
//    a tolerated data race). A seqlock gives the 4 kHz reader tear-free
//    snapshots with no locking at all.
//  - UdpLink: non-blocking UDP send/recv for the robot bridge
//    (HardwareInterface.cpp:7 UDP 192.168.123.10:8007 and
//    unitree_legged_real/src/exe/ros_udp.cpp:28-31).
//  - SpscQueue: lock-free single-producer single-consumer byte-frame queue
//    for log/telemetry shipping off the real-time path (LeggedLogger role).
//
// C ABI only; consumed from Python via ctypes (quaternion_mpc_tpu/runtime/native.py).

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <ctime>
#include <new>

#include <arpa/inet.h>
#include <fcntl.h>
#include <pthread.h>
#include <sched.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

constexpr int64_t kNsPerSec = 1000000000LL;

int64_t now_ns() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return int64_t(ts.tv_sec) * kNsPerSec + ts.tv_nsec;
}

void sleep_until_ns(int64_t t_ns) {
  timespec ts;
  ts.tv_sec = t_ns / kNsPerSec;
  ts.tv_nsec = t_ns % kNsPerSec;
  while (clock_nanosleep(CLOCK_MONOTONIC, TIMER_ABSTIME, &ts, nullptr) == EINTR) {
  }
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// RateLoop
// ---------------------------------------------------------------------------

struct QmpcRateLoop {
  int64_t period_ns = 0;
  int64_t next_deadline_ns = 0;
  // stats
  uint64_t ticks = 0;
  uint64_t overruns = 0;
  int64_t max_lateness_ns = 0;
  int64_t sum_lateness_ns = 0;
};

QmpcRateLoop* qmpc_rate_loop_create(double period_s) {
  auto* rl = new (std::nothrow) QmpcRateLoop();
  if (!rl) return nullptr;
  rl->period_ns = int64_t(period_s * 1e9);
  rl->next_deadline_ns = now_ns() + rl->period_ns;
  return rl;
}

void qmpc_rate_loop_destroy(QmpcRateLoop* rl) { delete rl; }

// Try to switch the CALLING thread to SCHED_FIFO at `priority` (Main.cpp
// uses 50/25/10). Returns 0 on success, errno otherwise (non-root → EPERM;
// callers degrade gracefully like the reference does in containers).
int qmpc_set_realtime_priority(int priority) {
  sched_param param;
  param.sched_priority = priority;
  if (pthread_setschedparam(pthread_self(), SCHED_FIFO, &param) != 0) {
    return errno ? errno : -1;
  }
  return 0;
}

// Sleep until this tick's absolute deadline; returns lateness (ns, >=0 when
// the deadline was missed before we were called — an overrun).
int64_t qmpc_rate_loop_wait(QmpcRateLoop* rl) {
  const int64_t now = now_ns();
  int64_t lateness = now - rl->next_deadline_ns;
  if (lateness < 0) {
    sleep_until_ns(rl->next_deadline_ns);
    lateness = 0;
  } else {
    ++rl->overruns;
    if (lateness > rl->max_lateness_ns) rl->max_lateness_ns = lateness;
    rl->sum_lateness_ns += lateness;
    // re-anchor: skip missed periods instead of bursting to catch up
    const int64_t missed = lateness / rl->period_ns;
    rl->next_deadline_ns += missed * rl->period_ns;
  }
  rl->next_deadline_ns += rl->period_ns;
  ++rl->ticks;
  return lateness;
}

uint64_t qmpc_rate_loop_ticks(const QmpcRateLoop* rl) { return rl->ticks; }
uint64_t qmpc_rate_loop_overruns(const QmpcRateLoop* rl) { return rl->overruns; }
int64_t qmpc_rate_loop_max_lateness_ns(const QmpcRateLoop* rl) {
  return rl->max_lateness_ns;
}

// ---------------------------------------------------------------------------
// StateBus — single-writer seqlock over an opaque byte blob.
// ---------------------------------------------------------------------------

struct QmpcStateBus {
  std::atomic<uint64_t> seq{0};
  uint32_t size = 0;
  alignas(64) uint8_t* data = nullptr;
};

QmpcStateBus* qmpc_state_bus_create(uint32_t size) {
  auto* bus = new (std::nothrow) QmpcStateBus();
  if (!bus) return nullptr;
  bus->size = size;
  bus->data = new (std::nothrow) uint8_t[size]();
  if (!bus->data) {
    delete bus;
    return nullptr;
  }
  return bus;
}

void qmpc_state_bus_destroy(QmpcStateBus* bus) {
  if (bus) delete[] bus->data;
  delete bus;
}

// Single writer: publish a new snapshot (odd seq = write in progress).
void qmpc_state_bus_write(QmpcStateBus* bus, const uint8_t* src, uint32_t n) {
  if (n > bus->size) n = bus->size;
  const uint64_t s = bus->seq.load(std::memory_order_relaxed);
  bus->seq.store(s + 1, std::memory_order_release);  // odd: writing
  std::atomic_thread_fence(std::memory_order_release);
  std::memcpy(bus->data, src, n);
  std::atomic_thread_fence(std::memory_order_release);
  bus->seq.store(s + 2, std::memory_order_release);  // even: stable
}

// Any-reader: tear-free snapshot; returns the (even) sequence number read,
// or 0 if nothing has been published yet. Retries across concurrent writes.
uint64_t qmpc_state_bus_read(const QmpcStateBus* bus, uint8_t* dst, uint32_t n) {
  if (n > bus->size) n = bus->size;
  while (true) {
    const uint64_t s1 = bus->seq.load(std::memory_order_acquire);
    if (s1 == 0) return 0;
    if (s1 & 1) continue;  // write in progress
    std::atomic_thread_fence(std::memory_order_acquire);
    std::memcpy(dst, bus->data, n);
    std::atomic_thread_fence(std::memory_order_acquire);
    const uint64_t s2 = bus->seq.load(std::memory_order_acquire);
    if (s1 == s2) return s1;
  }
}

// ---------------------------------------------------------------------------
// SpscQueue — lock-free SPSC ring of length-prefixed frames.
// ---------------------------------------------------------------------------

struct QmpcSpscQueue {
  uint8_t* buf = nullptr;
  uint32_t capacity = 0;  // power of two
  alignas(64) std::atomic<uint32_t> head{0};  // consumer
  alignas(64) std::atomic<uint32_t> tail{0};  // producer
};

QmpcSpscQueue* qmpc_spsc_create(uint32_t capacity_pow2) {
  if (capacity_pow2 == 0 || (capacity_pow2 & (capacity_pow2 - 1)) != 0) {
    return nullptr;
  }
  auto* q = new (std::nothrow) QmpcSpscQueue();
  if (!q) return nullptr;
  q->buf = new (std::nothrow) uint8_t[capacity_pow2];
  if (!q->buf) {
    delete q;
    return nullptr;
  }
  q->capacity = capacity_pow2;
  return q;
}

void qmpc_spsc_destroy(QmpcSpscQueue* q) {
  if (q) delete[] q->buf;
  delete q;
}

static void spsc_copy_in(QmpcSpscQueue* q, uint32_t pos, const uint8_t* src,
                         uint32_t n) {
  const uint32_t mask = q->capacity - 1;
  for (uint32_t i = 0; i < n; ++i) q->buf[(pos + i) & mask] = src[i];
}

static void spsc_copy_out(const QmpcSpscQueue* q, uint32_t pos, uint8_t* dst,
                          uint32_t n) {
  const uint32_t mask = q->capacity - 1;
  for (uint32_t i = 0; i < n; ++i) dst[i] = q->buf[(pos + i) & mask];
}

// Producer: returns 1 on success, 0 when the frame doesn't fit (dropped —
// telemetry must never block the real-time path).
int qmpc_spsc_push(QmpcSpscQueue* q, const uint8_t* frame, uint32_t n) {
  const uint32_t head = q->head.load(std::memory_order_acquire);
  const uint32_t tail = q->tail.load(std::memory_order_relaxed);
  const uint32_t free_bytes = q->capacity - (tail - head);
  if (n + 4 > free_bytes) return 0;
  uint8_t len[4];
  std::memcpy(len, &n, 4);
  spsc_copy_in(q, tail, len, 4);
  spsc_copy_in(q, tail + 4, frame, n);
  q->tail.store(tail + 4 + n, std::memory_order_release);
  return 1;
}

// Consumer: returns frame length (0 = empty; >max_n = frame truncated to max_n).
uint32_t qmpc_spsc_pop(QmpcSpscQueue* q, uint8_t* out, uint32_t max_n) {
  const uint32_t tail = q->tail.load(std::memory_order_acquire);
  const uint32_t head = q->head.load(std::memory_order_relaxed);
  if (tail == head) return 0;
  uint32_t n;
  uint8_t len[4];
  spsc_copy_out(q, head, len, 4);
  std::memcpy(&n, len, 4);
  const uint32_t take = n < max_n ? n : max_n;
  spsc_copy_out(q, head + 4, out, take);
  q->head.store(head + 4 + n, std::memory_order_release);
  return n;
}

// ---------------------------------------------------------------------------
// UdpLink — non-blocking UDP endpoint.
// ---------------------------------------------------------------------------

struct QmpcUdpLink {
  int fd = -1;
  sockaddr_in peer{};
  bool has_peer = false;
};

// bind_port = 0 → ephemeral. peer_ip nullable (recv-only link).
QmpcUdpLink* qmpc_udp_create(const char* peer_ip, uint16_t peer_port,
                             uint16_t bind_port) {
  auto* link = new (std::nothrow) QmpcUdpLink();
  if (!link) return nullptr;
  link->fd = socket(AF_INET, SOCK_DGRAM | SOCK_NONBLOCK, 0);
  if (link->fd < 0) {
    delete link;
    return nullptr;
  }
  sockaddr_in local{};
  local.sin_family = AF_INET;
  local.sin_addr.s_addr = htonl(INADDR_ANY);
  local.sin_port = htons(bind_port);
  if (bind(link->fd, reinterpret_cast<sockaddr*>(&local), sizeof(local)) < 0) {
    close(link->fd);
    delete link;
    return nullptr;
  }
  if (peer_ip && peer_ip[0]) {
    link->peer.sin_family = AF_INET;
    link->peer.sin_port = htons(peer_port);
    if (inet_pton(AF_INET, peer_ip, &link->peer.sin_addr) == 1) {
      link->has_peer = true;
    }
  }
  return link;
}

void qmpc_udp_destroy(QmpcUdpLink* link) {
  if (link && link->fd >= 0) close(link->fd);
  delete link;
}

uint16_t qmpc_udp_local_port(const QmpcUdpLink* link) {
  sockaddr_in local{};
  socklen_t len = sizeof(local);
  if (getsockname(link->fd, reinterpret_cast<sockaddr*>(const_cast<sockaddr_in*>(&local)),
                  &len) != 0) {
    return 0;
  }
  return ntohs(local.sin_port);
}

int64_t qmpc_udp_send(QmpcUdpLink* link, const uint8_t* data, uint32_t n) {
  if (!link->has_peer) return -EDESTADDRREQ;
  const ssize_t sent =
      sendto(link->fd, data, n, 0, reinterpret_cast<sockaddr*>(&link->peer),
             sizeof(link->peer));
  return sent < 0 ? -errno : sent;
}

// Non-blocking receive; returns -EAGAIN when no datagram is pending.
// A link created WITHOUT a peer (server role — the sim-robot side of the
// loopback demo) learns its peer from the first datagram's sender, so
// replies go back to whoever is driving it.
int64_t qmpc_udp_recv(QmpcUdpLink* link, uint8_t* out, uint32_t max_n) {
  sockaddr_in from{};
  socklen_t from_len = sizeof(from);
  const ssize_t got = recvfrom(link->fd, out, max_n, 0,
                               reinterpret_cast<sockaddr*>(&from), &from_len);
  if (got >= 0 && !link->has_peer) {
    link->peer = from;
    link->has_peer = true;
  }
  return got < 0 ? -errno : got;
}

int64_t qmpc_now_ns() { return now_ns(); }

}  // extern "C"
