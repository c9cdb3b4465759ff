// TCPStore — native KV rendezvous store (host code, not a device kernel).
//
// The port's own copy of the JAX package's paddle_tpu/core/native/
// tcp_store.cc, byte for byte in its logic, so that the two stores speak
// one wire protocol: a master daemon owning an in-memory KV map with
// blocking waits, used to bootstrap distributed jobs (peer registration,
// barriers) beside torch.distributed's own rendezvous.
//
// Design: one daemon thread, poll(2)-driven, single-threaded state — no
// locks on the KV map, waiters parked on a list and woken on SET/ADD.
// Client sockets are NON-BLOCKING with per-connection receive buffers:
// a request is dispatched only once fully buffered, so a client that
// stalls mid-request (SIGSTOP, partition) cannot wedge the daemon — other
// ranks keep being served and waiter timeouts keep firing. Replies use a
// bounded-wait send; a connection that cannot drain its reply within
// kSendTimeoutMs is dropped.
// Exposed through a C ABI consumed from Python via ctypes
// (paddle_tpu_torch/distributed/store.py, which builds it with g++ into
// build/paddle_tpu_torch/), which also implements the same wire protocol
// in pure Python as a fallback — the two interoperate.
//
// Wire protocol (little-endian):
//   request:  u8 cmd | u32 keylen | key bytes | payload
//     cmd=1 SET   payload = u32 vallen | val
//     cmd=2 GET   payload = i64 timeout_ms   (blocks until key exists)
//     cmd=3 ADD   payload = i64 delta        (creates key at 0 first)
//     cmd=4 WAIT  payload = i64 timeout_ms
//     cmd=5 DEL   payload = none
//   response: u8 status (0 ok / 1 timeout) | u32 vallen | val bytes
//     (SET/DEL respond vallen=0; ADD responds val = ascii of new value)

#include <arpa/inet.h>
#include <errno.h>
#include <fcntl.h>
#include <netdb.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string.h>
#include <sys/socket.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <list>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

using Clock = std::chrono::steady_clock;

int64_t now_ms() {
  return std::chrono::duration_cast<std::chrono::milliseconds>(
             Clock::now().time_since_epoch())
      .count();
}

// ---------------------------------------------------------------- util io
bool send_all(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n <= 0) {
      if (n < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool recv_all(int fd, void* buf, size_t len) {
  char* p = static_cast<char*>(buf);
  while (len > 0) {
    ssize_t n = ::recv(fd, p, len, 0);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    p += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

// --------------------------------------------------------------- daemon
constexpr int kSendTimeoutMs = 5000;

// Bounded-wait send on a non-blocking fd: waits for POLLOUT on EAGAIN,
// gives up after kSendTimeoutMs so one undrained client can't stall the
// daemon thread forever.
bool send_bounded(int fd, const void* buf, size_t len) {
  const char* p = static_cast<const char*>(buf);
  int64_t deadline = now_ms() + kSendTimeoutMs;
  while (len > 0) {
    ssize_t n = ::send(fd, p, len, MSG_NOSIGNAL);
    if (n > 0) {
      p += n;
      len -= static_cast<size_t>(n);
      continue;
    }
    if (n < 0 && errno == EINTR) continue;
    if (n < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) {
      int64_t rem = deadline - now_ms();
      if (rem <= 0) return false;
      pollfd pfd{fd, POLLOUT, 0};
      ::poll(&pfd, 1, static_cast<int>(std::min<int64_t>(rem, 200)));
      continue;
    }
    return false;
  }
  return true;
}

struct Waiter {
  int fd;
  std::string key;
  int64_t deadline_ms;  // -1 = infinite
  bool reply_value;     // GET replies value, WAIT replies status only
};

struct Conn {
  int fd;
  std::string inbuf;  // bytes received but not yet forming a full request
};

struct Daemon {
  int listen_fd = -1;
  int port = 0;
  std::atomic<bool> stop{false};
  std::thread thread;
  std::unordered_map<std::string, std::string> kv;
  std::list<Waiter> waiters;
  // fds whose waiter-path reply failed: the byte stream is desynced, so the
  // connection must be dropped (deferred to run()'s drop phase — dropping
  // here would invalidate the client list mid-iteration)
  std::vector<int> failed_fds;

  // false → connection must be dropped (reply could not be delivered)
  bool reply(int fd, uint8_t status, const std::string& val) {
    uint32_t vlen = static_cast<uint32_t>(val.size());
    std::string out;
    out.push_back(static_cast<char>(status));
    out.append(reinterpret_cast<const char*>(&vlen), 4);
    out += val;
    return send_bounded(fd, out.data(), out.size());
  }

  void wake_waiters(const std::string& key) {
    for (auto it = waiters.begin(); it != waiters.end();) {
      if (it->key == key) {
        if (!reply(it->fd, 0, it->reply_value ? kv[key] : std::string()))
          failed_fds.push_back(it->fd);
        it = waiters.erase(it);
      } else {
        ++it;
      }
    }
  }

  // Try to consume ONE complete request from c.inbuf.
  // Returns 1 = handled, 0 = need more bytes, -1 = drop connection.
  int try_handle(Conn& c) {
    const char* p = c.inbuf.data();
    size_t avail = c.inbuf.size();
    if (avail < 5) return 0;
    uint8_t cmd = static_cast<uint8_t>(p[0]);
    uint32_t klen;
    memcpy(&klen, p + 1, 4);
    if (klen > (1u << 20)) return -1;
    size_t fixed;  // payload bytes after the key, before any value
    switch (cmd) {
      case 1: fixed = 4; break;            // SET: u32 vallen
      case 2: case 3: case 4: fixed = 8; break;  // GET/ADD/WAIT: i64
      case 5: fixed = 0; break;            // DEL
      default: return -1;
    }
    size_t base = 5 + static_cast<size_t>(klen);
    if (avail < base + fixed) return 0;
    uint32_t vlen = 0;
    if (cmd == 1) {
      memcpy(&vlen, p + base, 4);
      if (vlen > (1u << 30)) return -1;
      if (avail < base + 4 + vlen) return 0;
    }
    std::string key(p + 5, klen);
    size_t consumed = base + fixed + (cmd == 1 ? vlen : 0);
    bool ok = true;
    switch (cmd) {
      case 1: {  // SET
        kv[key] = std::string(p + base + 4, vlen);
        wake_waiters(key);
        ok = reply(c.fd, 0, "");
        break;
      }
      case 2:    // GET (blocking)
      case 4: {  // WAIT
        int64_t timeout_ms;
        memcpy(&timeout_ms, p + base, 8);
        auto it = kv.find(key);
        if (it != kv.end()) {
          ok = reply(c.fd, 0, cmd == 2 ? it->second : std::string());
        } else {
          Waiter w;
          w.fd = c.fd;
          w.key = key;
          w.deadline_ms = timeout_ms < 0 ? -1 : now_ms() + timeout_ms;
          w.reply_value = (cmd == 2);
          waiters.push_back(std::move(w));
        }
        break;
      }
      case 3: {  // ADD
        int64_t delta;
        memcpy(&delta, p + base, 8);
        int64_t cur = 0;
        auto it = kv.find(key);
        if (it != kv.end() && !it->second.empty())
          cur = strtoll(it->second.c_str(), nullptr, 10);
        cur += delta;
        kv[key] = std::to_string(cur);
        wake_waiters(key);
        ok = reply(c.fd, 0, std::to_string(cur));
        break;
      }
      case 5: {  // DEL
        kv.erase(key);
        ok = reply(c.fd, 0, "");
        break;
      }
    }
    c.inbuf.erase(0, consumed);
    return ok ? 1 : -1;
  }

  void drop_fd_waiters(int fd) {
    for (auto it = waiters.begin(); it != waiters.end();)
      it = (it->fd == fd) ? waiters.erase(it) : std::next(it);
  }

  void run() {
    std::vector<Conn> clients;
    auto drop = [&](int fd) {
      drop_fd_waiters(fd);
      ::close(fd);
      clients.erase(std::remove_if(clients.begin(), clients.end(),
                                   [fd](const Conn& c) { return c.fd == fd; }),
                    clients.end());
    };
    while (!stop.load(std::memory_order_relaxed)) {
      std::vector<pollfd> pfds;
      pfds.push_back({listen_fd, POLLIN, 0});
      for (const Conn& c : clients) pfds.push_back({c.fd, POLLIN, 0});
      int rc = ::poll(pfds.data(), pfds.size(), 100);
      if (rc < 0 && errno != EINTR) break;

      // expire timed-out waiters
      int64_t t = now_ms();
      for (auto it = waiters.begin(); it != waiters.end();) {
        if (it->deadline_ms >= 0 && t >= it->deadline_ms) {
          if (!reply(it->fd, 1, "")) failed_fds.push_back(it->fd);
          it = waiters.erase(it);
        } else {
          ++it;
        }
      }
      if (rc <= 0) {
        for (int fd : failed_fds) drop(fd);
        failed_fds.clear();
        continue;
      }

      if (pfds[0].revents & POLLIN) {
        int c = ::accept(listen_fd, nullptr, nullptr);
        if (c >= 0) {
          int one = 1;
          setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
          fcntl(c, F_SETFL, fcntl(c, F_GETFL, 0) | O_NONBLOCK);
          clients.push_back(Conn{c, std::string()});
        }
      }
      std::vector<int> dead;
      for (size_t i = 1; i < pfds.size(); ++i) {
        if (!(pfds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
        Conn& c = clients[i - 1];
        bool closed = false;
        if (pfds[i].revents & POLLIN) {
          char buf[65536];
          for (;;) {  // drain what the kernel has; never block
            ssize_t n = ::recv(c.fd, buf, sizeof(buf), 0);
            if (n > 0) {
              c.inbuf.append(buf, static_cast<size_t>(n));
              continue;
            }
            if (n == 0) closed = true;
            else if (errno == EINTR) continue;
            else if (errno != EAGAIN && errno != EWOULDBLOCK) closed = true;
            break;
          }
        } else {
          closed = true;  // HUP/ERR with no data
        }
        int h;
        while ((h = try_handle(c)) == 1) {}
        if (h == -1 || closed) dead.push_back(c.fd);
      }
      dead.insert(dead.end(), failed_fds.begin(), failed_fds.end());
      failed_fds.clear();
      std::sort(dead.begin(), dead.end());
      dead.erase(std::unique(dead.begin(), dead.end()), dead.end());
      for (int fd : dead) drop(fd);
    }
    for (const Conn& c : clients) ::close(c.fd);
    if (listen_fd >= 0) ::close(listen_fd);
  }
};

// --------------------------------------------------------------- client
struct Client {
  int fd = -1;
};

bool client_request(Client* c, uint8_t cmd, const std::string& key,
                    const std::string& payload, uint8_t* status,
                    std::string* val) {
  std::string msg;
  msg.push_back(static_cast<char>(cmd));
  uint32_t klen = static_cast<uint32_t>(key.size());
  msg.append(reinterpret_cast<const char*>(&klen), 4);
  msg += key;
  msg += payload;
  if (!send_all(c->fd, msg.data(), msg.size())) return false;
  uint8_t st;
  uint32_t vlen;
  if (!recv_all(c->fd, &st, 1) || !recv_all(c->fd, &vlen, 4)) return false;
  val->resize(vlen);
  if (vlen && !recv_all(c->fd, &(*val)[0], vlen)) return false;
  *status = st;
  return true;
}

}  // namespace

// ------------------------------------------------------------------ C ABI
extern "C" {

// Start master daemon; port=0 picks an ephemeral port. Returns handle or
// nullptr. The bound port is written to *out_port.
void* ts_master_start(int port, int* out_port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_ANY);
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0 ||
      ::listen(fd, 128) < 0) {
    ::close(fd);
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  getsockname(fd, reinterpret_cast<sockaddr*>(&addr), &alen);
  auto* d = new Daemon();
  d->listen_fd = fd;
  d->port = ntohs(addr.sin_port);
  if (out_port) *out_port = d->port;
  d->thread = std::thread([d] { d->run(); });
  return d;
}

void ts_master_stop(void* h) {
  auto* d = static_cast<Daemon*>(h);
  if (!d) return;
  d->stop.store(true);
  if (d->thread.joinable()) d->thread.join();
  delete d;
}

void* ts_client_connect(const char* host, int port, int timeout_ms) {
  addrinfo hints{}, *res = nullptr;
  hints.ai_family = AF_INET;
  hints.ai_socktype = SOCK_STREAM;
  char portstr[16];
  snprintf(portstr, sizeof(portstr), "%d", port);
  if (getaddrinfo(host, portstr, &hints, &res) != 0 || !res) return nullptr;
  int64_t deadline = now_ms() + timeout_ms;
  int fd = -1;
  // retry loop: master may not be up yet (launch races rendezvous)
  while (now_ms() < deadline || timeout_ms < 0) {
    fd = ::socket(res->ai_family, res->ai_socktype, res->ai_protocol);
    if (fd < 0) break;
    if (::connect(fd, res->ai_addr, res->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
    usleep(100 * 1000);
  }
  freeaddrinfo(res);
  if (fd < 0) return nullptr;
  int one = 1;
  setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client();
  c->fd = fd;
  return c;
}

void ts_client_close(void* h) {
  auto* c = static_cast<Client*>(h);
  if (!c) return;
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

// Returns 0 ok, 1 timeout, -1 connection error.
int ts_set(void* h, const char* key, const char* val, int vlen) {
  auto* c = static_cast<Client*>(h);
  std::string payload;
  uint32_t v = static_cast<uint32_t>(vlen);
  payload.append(reinterpret_cast<const char*>(&v), 4);
  payload.append(val, vlen);
  uint8_t st;
  std::string out;
  if (!client_request(c, 1, key, payload, &st, &out)) return -1;
  return st;
}

// GET: blocks server-side up to timeout_ms (-1 infinite). The caller owns
// no memory: value is copied into out_buf (capacity out_cap); actual length
// written to *out_len. Returns 0 ok, 1 timeout, -1 error, -2 buffer small.
int ts_get(void* h, const char* key, int64_t timeout_ms, char* out_buf,
           int out_cap, int* out_len) {
  auto* c = static_cast<Client*>(h);
  std::string payload(reinterpret_cast<const char*>(&timeout_ms), 8);
  uint8_t st;
  std::string out;
  if (!client_request(c, 2, key, payload, &st, &out)) return -1;
  if (st != 0) return st;
  if (static_cast<int>(out.size()) > out_cap) return -2;
  memcpy(out_buf, out.data(), out.size());
  *out_len = static_cast<int>(out.size());
  return 0;
}

// ADD: atomic fetch-add on ascii-integer key; new value via *out_val.
int ts_add(void* h, const char* key, int64_t delta, int64_t* out_val) {
  auto* c = static_cast<Client*>(h);
  std::string payload(reinterpret_cast<const char*>(&delta), 8);
  uint8_t st;
  std::string out;
  if (!client_request(c, 3, key, payload, &st, &out)) return -1;
  if (st != 0) return st;
  *out_val = strtoll(out.c_str(), nullptr, 10);
  return 0;
}

int ts_wait(void* h, const char* key, int64_t timeout_ms) {
  auto* c = static_cast<Client*>(h);
  std::string payload(reinterpret_cast<const char*>(&timeout_ms), 8);
  uint8_t st;
  std::string out;
  if (!client_request(c, 4, key, payload, &st, &out)) return -1;
  return st;
}

int ts_del(void* h, const char* key) {
  auto* c = static_cast<Client*>(h);
  uint8_t st;
  std::string out;
  if (!client_request(c, 5, key, "", &st, &out)) return -1;
  return st;
}

}  // extern "C"
