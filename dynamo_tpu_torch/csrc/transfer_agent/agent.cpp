// transfer_agent: RDMA-style one-sided block transfer over TCP (DCN path).
//
// The role NIXL (external C++ repo, consumed via nixl-sys FFI in the
// reference's block_manager) plays for GPU clusters: a peer registers
// memory regions; remote peers WRITE bytes straight into those regions
// (kernel->memcpy into the registered arena, no Python in the data path)
// and post a NOTIFY carrying opaque metadata; the owning process drains a
// completion queue. READ provides the symmetric one-sided fetch.
//
// Wire protocol (little-endian), framed per message:
//   WRITE : u8 op=1 | u64 region | u64 offset | u64 len | payload[len]
//   NOTIFY: u8 op=2 | u64 tag    | u32 mlen   | meta[mlen]
//   READ  : u8 op=3 | u64 region | u64 offset | u64 len
//        -> u8 ok   | u64 len    | payload[len]
//   AUTH  : u8 op=4 | token[16]
//   (WRITE and NOTIFY are one-way; only READ has a response, so a stream
//    of writes pipelines without round trips.)
//
// When the server is created with a 16-byte token, a connection must AUTH
// before any other op is accepted (wrong token or premature op closes the
// connection). The token is distributed out of band via the trusted
// control plane, so an arbitrary network peer that can reach the port
// cannot write into registered arenas.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>

namespace {

struct Region {
  uint8_t *base;
  uint64_t len;
  // Server-assigned registration epoch: in-flight chunked transfers
  // capture it at the first chunk and bounce if the id is unregistered
  // and re-registered (same id, new epoch) mid-transfer.
  uint64_t gen;
};

struct Completion {
  uint64_t tag;
  std::vector<uint8_t> meta;
};

struct Server {
  int listen_fd = -1;
  uint16_t port = 0;
  std::thread loop;
  std::mutex mu;
  std::unordered_map<uint64_t, Region> regions;
  uint64_t next_gen = 1;
  std::deque<Completion> completions;
  bool stopping = false;
  int wake_pipe[2] = {-1, -1};
  bool require_auth = false;
  uint8_t token[16] = {0};
};

// Constant-time compare — a timing oracle must not leak the token.
bool token_eq(const uint8_t *a, const uint8_t *b) {
  uint8_t d = 0;
  for (int i = 0; i < 16; ++i) d |= a[i] ^ b[i];
  return d == 0;
}

bool read_full(int fd, void *buf, size_t n) {
  uint8_t *p = static_cast<uint8_t *>(buf);
  while (n) {
    ssize_t r = ::recv(fd, p, n, 0);
    if (r <= 0) {
      if (r < 0 && (errno == EINTR)) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

bool write_full(int fd, const void *buf, size_t n) {
  const uint8_t *p = static_cast<const uint8_t *>(buf);
  while (n) {
    ssize_t r = ::send(fd, p, n, MSG_NOSIGNAL);
    if (r <= 0) {
      if (r < 0 && errno == EINTR) continue;
      return false;
    }
    p += r;
    n -= static_cast<size_t>(r);
  }
  return true;
}

constexpr uint64_t kMaxTransfer = 1ull << 32;  // 4 GiB sanity bound
constexpr size_t kChunk = 4u << 20;  // streaming chunk: bounds scratch
                                     // memory and mutex hold per transfer

// Serve one message from a connected peer. Returns false on EOF/error.
bool serve_one(Server *s, int fd, bool &authed) {
  uint8_t op;
  if (!read_full(fd, &op, 1)) return false;
  if (op == 4) {  // AUTH
    uint8_t tok[16];
    if (!read_full(fd, tok, 16)) return false;
    if (s->require_auth && !token_eq(tok, s->token)) return false;
    authed = true;
    return true;
  }
  if (s->require_auth && !authed) return false;  // auth-first, or drop
  if (op == 1) {  // WRITE
    uint64_t region, offset, len;
    if (!read_full(fd, &region, 8) || !read_full(fd, &offset, 8) ||
        !read_full(fd, &len, 8))
      return false;
    if (len > kMaxTransfer) return false;
    // Stream in bounded chunks; each chunk commits under the lock after
    // RE-validating the region AND its registration epoch — a region
    // unregistered (even if the same id is immediately re-registered for
    // a new owner) mid-transfer bounces the remaining chunks instead of
    // scribbling over the slot's next user. An invalid region from the
    // start just drains the payload to keep the stream sane. Chunking
    // keeps scratch memory and mutex hold O(kChunk), not O(len).
    std::vector<uint8_t> buf(
        len < kChunk ? static_cast<size_t>(len) : kChunk);
    uint64_t pos = 0;
    uint64_t gen = 0;  // captured at first committed chunk
    while (pos < len) {
      size_t chunk = static_cast<size_t>(
          len - pos < buf.size() ? len - pos : buf.size());
      if (!read_full(fd, buf.data(), chunk)) return false;
      std::lock_guard<std::mutex> g(s->mu);
      auto it = s->regions.find(region);
      // Overflow-safe bounds check: offset + len can wrap in u64.
      if (it != s->regions.end() && offset <= it->second.len &&
          len <= it->second.len - offset &&
          (gen == 0 || gen == it->second.gen)) {
        gen = it->second.gen;
        std::memcpy(it->second.base + offset + pos, buf.data(), chunk);
      } else {
        gen = UINT64_MAX;  // poisoned: never commit again, keep draining
      }
      pos += chunk;
    }
    return true;
  }
  if (op == 2) {  // NOTIFY
    uint64_t tag;
    uint32_t mlen;
    if (!read_full(fd, &tag, 8) || !read_full(fd, &mlen, 4)) return false;
    if (mlen > (1u << 24)) return false;
    Completion c;
    c.tag = tag;
    c.meta.resize(mlen);
    if (mlen && !read_full(fd, c.meta.data(), mlen)) return false;
    std::lock_guard<std::mutex> g(s->mu);
    s->completions.push_back(std::move(c));
    return true;
  }
  if (op == 3) {  // READ
    uint64_t region, offset, len;
    if (!read_full(fd, &region, 8) || !read_full(fd, &offset, 8) ||
        !read_full(fd, &len, 8))
      return false;
    if (len > kMaxTransfer) return false;
    uint8_t ok = 0;
    uint64_t gen = 0;
    {
      std::lock_guard<std::mutex> g(s->mu);
      auto it = s->regions.find(region);
      // Overflow-safe bounds check: offset + len can wrap in u64.
      if (it != s->regions.end() && offset <= it->second.len &&
          len <= it->second.len - offset) {
        ok = 1;
        gen = it->second.gen;
      }
    }
    if (!write_full(fd, &ok, 1)) return false;
    uint64_t out_len = ok ? len : 0;
    if (!write_full(fd, &out_len, 8)) return false;
    if (!ok) return true;
    // Copy out in bounded chunks, re-validating region + epoch per chunk
    // (symmetric to WRITE: the region may be unregistered, or its id
    // recycled, while a slow peer drains the response). Once the length
    // is promised a vanished region can't be retracted in-band, so FAIL
    // HARD — drop the connection and let the client's short read surface
    // the race as an error rather than silently landing half-stale
    // bytes. Bounds scratch memory and mutex hold at O(kChunk).
    std::vector<uint8_t> buf(
        len < kChunk ? static_cast<size_t>(len) : kChunk);
    uint64_t pos = 0;
    while (pos < len) {
      size_t chunk = static_cast<size_t>(
          len - pos < buf.size() ? len - pos : buf.size());
      {
        std::lock_guard<std::mutex> g(s->mu);
        auto it = s->regions.find(region);
        if (it == s->regions.end() || it->second.gen != gen ||
            offset > it->second.len || len > it->second.len - offset)
          return false;
        std::memcpy(buf.data(), it->second.base + offset + pos, chunk);
      }
      if (!write_full(fd, buf.data(), chunk)) return false;
      pos += chunk;
    }
    return true;
  }
  return false;
}

void server_loop(Server *s) {
  std::unordered_map<int, bool> clients;  // fd -> authed
  while (true) {
    std::vector<pollfd> fds;
    fds.push_back({s->listen_fd, POLLIN, 0});
    fds.push_back({s->wake_pipe[0], POLLIN, 0});
    for (auto &c : clients) fds.push_back({c.first, POLLIN, 0});
    if (::poll(fds.data(), fds.size(), -1) < 0) {
      if (errno == EINTR) continue;
      break;
    }
    {
      std::lock_guard<std::mutex> g(s->mu);
      if (s->stopping) break;
    }
    if (fds[0].revents & POLLIN) {
      int c = ::accept(s->listen_fd, nullptr, nullptr);
      if (c >= 0) {
        int one = 1;
        ::setsockopt(c, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
        clients.emplace(c, false);
      }
    }
    for (size_t i = 2; i < fds.size(); ++i) {
      if (!(fds[i].revents & (POLLIN | POLLHUP | POLLERR))) continue;
      int fd = fds[i].fd;
      // Serve messages until the socket would block (level-triggered poll
      // re-arms us; serve_one blocks only mid-message, which is fine).
      if (!serve_one(s, fd, clients[fd])) {
        ::close(fd);
        clients.erase(fd);
      }
    }
  }
  for (auto &c : clients) ::close(c.first);
}

}  // namespace

extern "C" {

// bind_host: dotted-quad address to bind ("0.0.0.0" to accept cross-host
// peers — the reference's NIXL plane is explicitly multi-node). NULL or ""
// binds loopback only. token: 16-byte shared secret peers must AUTH with
// before any other op, or NULL to disable (loopback-only test setups).
void *ta_create(const char *bind_host, uint16_t port, const uint8_t *token) {
  auto *s = new Server();
  if (token) {
    s->require_auth = true;
    std::memcpy(s->token, token, 16);
  }
  s->listen_fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (s->listen_fd < 0) {
    delete s;
    return nullptr;
  }
  int one = 1;
  ::setsockopt(s->listen_fd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof(one));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_addr.s_addr = htonl(INADDR_LOOPBACK);
  if (bind_host && bind_host[0] &&
      ::inet_pton(AF_INET, bind_host, &addr.sin_addr) != 1) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  addr.sin_port = htons(port);
  if (::bind(s->listen_fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) <
          0 ||
      ::listen(s->listen_fd, 64) < 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  socklen_t alen = sizeof(addr);
  ::getsockname(s->listen_fd, reinterpret_cast<sockaddr *>(&addr), &alen);
  s->port = ntohs(addr.sin_port);
  if (::pipe(s->wake_pipe) != 0) {
    ::close(s->listen_fd);
    delete s;
    return nullptr;
  }
  s->loop = std::thread(server_loop, s);
  return s;
}

uint16_t ta_port(void *h) { return static_cast<Server *>(h)->port; }

int ta_register(void *h, uint64_t region_id, void *base, uint64_t len) {
  auto *s = static_cast<Server *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  s->regions[region_id] = {static_cast<uint8_t *>(base), len, s->next_gen++};
  return 0;
}

int ta_unregister(void *h, uint64_t region_id) {
  auto *s = static_cast<Server *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  return s->regions.erase(region_id) ? 0 : -1;
}

// Drain one completion. Returns meta length >= 0, or -1 if queue empty,
// or -2 if meta_cap too small (completion left queued).
int64_t ta_poll(void *h, uint64_t *tag_out, uint8_t *meta_out,
                uint32_t meta_cap) {
  auto *s = static_cast<Server *>(h);
  std::lock_guard<std::mutex> g(s->mu);
  if (s->completions.empty()) return -1;
  Completion &c = s->completions.front();
  if (c.meta.size() > meta_cap) return -2;
  *tag_out = c.tag;
  if (!c.meta.empty()) std::memcpy(meta_out, c.meta.data(), c.meta.size());
  int64_t n = static_cast<int64_t>(c.meta.size());
  s->completions.pop_front();
  return n;
}

void ta_destroy(void *h) {
  auto *s = static_cast<Server *>(h);
  {
    std::lock_guard<std::mutex> g(s->mu);
    s->stopping = true;
  }
  char b = 1;
  (void)!::write(s->wake_pipe[1], &b, 1);
  s->loop.join();
  ::close(s->listen_fd);
  ::close(s->wake_pipe[0]);
  ::close(s->wake_pipe[1]);
  delete s;
}

// ---- client side ----------------------------------------------------------

struct Conn {
  int fd;
  std::mutex mu;
};

// token: 16-byte shared secret to AUTH with right after connecting, or
// NULL to skip (server must have auth disabled).
void *ta_connect(const char *host, uint16_t port, const uint8_t *token) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(port);
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr *>(&addr), sizeof(addr)) < 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  if (token) {
    uint8_t op = 4;
    if (!write_full(fd, &op, 1) || !write_full(fd, token, 16)) {
      ::close(fd);
      return nullptr;
    }
  }
  auto *c = new Conn();
  c->fd = fd;
  return c;
}

int ta_write(void *conn, uint64_t region, uint64_t offset, const void *data,
             uint64_t len) {
  auto *c = static_cast<Conn *>(conn);
  std::lock_guard<std::mutex> g(c->mu);
  uint8_t op = 1;
  if (!write_full(c->fd, &op, 1) || !write_full(c->fd, &region, 8) ||
      !write_full(c->fd, &offset, 8) || !write_full(c->fd, &len, 8) ||
      !write_full(c->fd, data, len))
    return -1;
  return 0;
}

int ta_notify(void *conn, uint64_t tag, const void *meta, uint32_t mlen) {
  auto *c = static_cast<Conn *>(conn);
  std::lock_guard<std::mutex> g(c->mu);
  uint8_t op = 2;
  if (!write_full(c->fd, &op, 1) || !write_full(c->fd, &tag, 8) ||
      !write_full(c->fd, &mlen, 4) ||
      (mlen && !write_full(c->fd, meta, mlen)))
    return -1;
  return 0;
}

int64_t ta_read(void *conn, uint64_t region, uint64_t offset, void *out,
                uint64_t len) {
  auto *c = static_cast<Conn *>(conn);
  std::lock_guard<std::mutex> g(c->mu);
  uint8_t op = 3;
  if (!write_full(c->fd, &op, 1) || !write_full(c->fd, &region, 8) ||
      !write_full(c->fd, &offset, 8) || !write_full(c->fd, &len, 8))
    return -1;
  uint8_t ok;
  uint64_t rlen;
  if (!read_full(c->fd, &ok, 1) || !read_full(c->fd, &rlen, 8)) return -1;
  if (!ok) return -2;
  if (rlen && !read_full(c->fd, out, rlen)) return -1;
  return static_cast<int64_t>(rlen);
}

void ta_close(void *conn) {
  auto *c = static_cast<Conn *>(conn);
  ::close(c->fd);
  delete c;
}

}  // extern "C"
