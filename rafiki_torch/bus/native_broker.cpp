// Native bus broker: C++ implementation of the project's TCP bus.
//
// Wire-compatible with bus/tcp.py (BusServer) of either package: 4-byte
// big-endian length + UTF-8 JSON frames; request {"op": ...}, response
// {"ok": true, "value": ...} / {"ok": false, "error": ...}. Python
// BusClient connects to either broker unchanged.
//
// Why native: the Python broker holds the GIL across frame
// parse/dispatch, so a node's control-plane traffic (query scatter,
// prediction gather, advisor RPC) serialises against model host code
// under load. This broker is a single-threaded poll() event loop with
// zero-copy payload handling: the "value" member of a push is captured
// as a raw JSON span and spliced verbatim into pop responses — payloads
// are never re-parsed or re-encoded.
//
// Blocking pops park the connection (the client protocol is synchronous
// per-socket, so a parked socket never carries another request) with a
// deadline; a push to the queue fulfils the oldest waiter directly.
//
// Build: g++ -O2 -std=c++17 -o native_broker native_broker.cpp
// Run:   native_broker [host] [port]   (port 0 = auto; prints "PORT <n>")

#include <arpa/inet.h>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <csignal>
#include <ctime>
#include <deque>
#include <fcntl.h>
#include <map>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <poll.h>
#include <string>
#include <sys/socket.h>
#include <unistd.h>
#include <vector>

static const size_t MAX_FRAME = 256u * 1024u * 1024u;

// ---------------------------------------------------------------------------
// Minimal JSON envelope scanner: top-level object members only; member
// values are captured as raw spans (payloads stay opaque bytes).
// ---------------------------------------------------------------------------

struct Span {
    const char* p = nullptr;
    size_t n = 0;
    bool ok() const { return p != nullptr; }
    std::string str() const { return std::string(p, n); }
};

struct Scanner {
    const char* p;
    const char* end;

    void ws() {
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' ||
                           *p == '\r'))
            ++p;
    }

    // Skip a string literal (opening quote already consumed by caller or
    // not); returns false on malformed input.
    bool skip_string() {
        if (p >= end || *p != '"') return false;
        ++p;
        while (p < end) {
            if (*p == '\\') {
                p += 2;  // escape: next char can't close the string
                continue;
            }
            if (*p == '"') {
                ++p;
                return true;
            }
            ++p;
        }
        return false;
    }

    // Skip any JSON value; returns its raw span.
    Span skip_value() {
        ws();
        Span out;
        out.p = p;
        if (p >= end) return Span{};
        if (*p == '"') {
            if (!skip_string()) return Span{};
        } else if (*p == '{' || *p == '[') {
            char open = *p, close = (open == '{') ? '}' : ']';
            int depth = 0;
            while (p < end) {
                if (*p == '"') {
                    if (!skip_string()) return Span{};
                    continue;
                }
                if (*p == open) ++depth;
                else if (*p == close) {
                    --depth;
                    if (depth == 0) {
                        ++p;
                        break;
                    }
                }
                ++p;
            }
            if (depth != 0) return Span{};
        } else {  // number / true / false / null
            while (p < end && *p != ',' && *p != '}' && *p != ']' &&
                   *p != ' ' && *p != '\t' && *p != '\n' && *p != '\r')
                ++p;
        }
        out.n = (size_t)(p - out.p);
        return out;
    }
};

// Decode a JSON string literal span (including quotes) to UTF-8.
static bool json_decode_string(Span s, std::string& out) {
    if (!s.ok() || s.n < 2 || s.p[0] != '"') return false;
    const char* p = s.p + 1;
    const char* end = s.p + s.n - 1;
    out.clear();
    out.reserve(s.n);
    auto emit_utf8 = [&out](uint32_t cp) {
        if (cp < 0x80) {
            out.push_back((char)cp);
        } else if (cp < 0x800) {
            out.push_back((char)(0xC0 | (cp >> 6)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        } else if (cp < 0x10000) {
            out.push_back((char)(0xE0 | (cp >> 12)));
            out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        } else {
            out.push_back((char)(0xF0 | (cp >> 18)));
            out.push_back((char)(0x80 | ((cp >> 12) & 0x3F)));
            out.push_back((char)(0x80 | ((cp >> 6) & 0x3F)));
            out.push_back((char)(0x80 | (cp & 0x3F)));
        }
    };
    while (p < end) {
        if (*p != '\\') {
            out.push_back(*p++);
            continue;
        }
        if (++p >= end) return false;
        char c = *p++;
        switch (c) {
            case '"': out.push_back('"'); break;
            case '\\': out.push_back('\\'); break;
            case '/': out.push_back('/'); break;
            case 'b': out.push_back('\b'); break;
            case 'f': out.push_back('\f'); break;
            case 'n': out.push_back('\n'); break;
            case 'r': out.push_back('\r'); break;
            case 't': out.push_back('\t'); break;
            case 'u': {
                if (end - p < 4) return false;
                uint32_t cp = (uint32_t)strtoul(
                    std::string(p, 4).c_str(), nullptr, 16);
                p += 4;
                if (cp >= 0xD800 && cp <= 0xDBFF && end - p >= 6 &&
                    p[0] == '\\' && p[1] == 'u') {  // surrogate pair
                    uint32_t lo = (uint32_t)strtoul(
                        std::string(p + 2, 4).c_str(), nullptr, 16);
                    if (lo >= 0xDC00 && lo <= 0xDFFF) {
                        cp = 0x10000 + ((cp - 0xD800) << 10) +
                             (lo - 0xDC00);
                        p += 6;
                    }
                }
                emit_utf8(cp);
                break;
            }
            default: return false;
        }
    }
    return true;
}

// JSON-encode a UTF-8 string.
static void json_encode_string(const std::string& in, std::string& out) {
    out.push_back('"');
    for (unsigned char c : in) {
        switch (c) {
            case '"': out += "\\\""; break;
            case '\\': out += "\\\\"; break;
            case '\b': out += "\\b"; break;
            case '\f': out += "\\f"; break;
            case '\n': out += "\\n"; break;
            case '\r': out += "\\r"; break;
            case '\t': out += "\\t"; break;
            default:
                if (c < 0x20) {
                    char buf[8];
                    snprintf(buf, sizeof buf, "\\u%04x", c);
                    out += buf;
                } else {
                    out.push_back((char)c);
                }
        }
    }
    out.push_back('"');
}

// Parse the request envelope: top-level members as raw spans.
static bool parse_envelope(const char* data, size_t n,
                           std::map<std::string, Span>& out) {
    Scanner sc{data, data + n};
    sc.ws();
    if (sc.p >= sc.end || *sc.p != '{') return false;
    ++sc.p;
    sc.ws();
    if (sc.p < sc.end && *sc.p == '}') return true;  // empty object
    while (true) {
        sc.ws();
        Span key;
        key.p = sc.p;
        if (!sc.skip_string()) return false;
        key.n = (size_t)(sc.p - key.p);
        std::string k;
        if (!json_decode_string(key, k)) return false;
        sc.ws();
        if (sc.p >= sc.end || *sc.p != ':') return false;
        ++sc.p;
        Span val = sc.skip_value();
        if (!val.ok()) return false;
        out[k] = val;
        sc.ws();
        if (sc.p >= sc.end) return false;
        if (*sc.p == ',') {
            ++sc.p;
            continue;
        }
        if (*sc.p == '}') return true;
        return false;
    }
}

// ---------------------------------------------------------------------------
// Broker state
// ---------------------------------------------------------------------------

struct Waiter {
    int fd;
    uint64_t gen;      // connection generation: fds get recycled by the
                       // kernel; a stale waiter must never match a new
                       // connection that happens to reuse the fd
    double deadline;   // monotonic seconds
    bool batch;        // pop_all vs pop
    long max_items;    // for pop_all
};

struct Conn {
    int fd = -1;
    uint64_t gen = 0;
    std::string rbuf;
    std::string wbuf;
    bool parked = false;  // a blocking pop is outstanding
};

static uint64_t next_gen = 1;

static std::map<int, Conn> conns;
static std::map<std::string, std::deque<std::string>> queues;
static std::map<std::string, std::deque<Waiter>> waiters;
static std::map<std::string, std::string> kv;

static double now_mono() {
    struct timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return (double)ts.tv_sec + (double)ts.tv_nsec * 1e-9;
}

static void queue_frame(Conn& c, const std::string& body) {
    uint32_t len = htonl((uint32_t)body.size());
    c.wbuf.append((const char*)&len, 4);
    c.wbuf.append(body);
}

static void respond_value(Conn& c, const std::string& raw_value) {
    std::string body = "{\"ok\":true,\"value\":";
    body += raw_value;
    body += "}";
    queue_frame(c, body);
}

static void respond_error(Conn& c, const std::string& msg) {
    std::string body = "{\"ok\":false,\"error\":";
    json_encode_string(msg, body);
    body += "}";
    queue_frame(c, body);
}

// Drain up to max_items (0/negative = unlimited) from a queue into a
// JSON array, starting with `first`.
static std::string drain_burst(std::deque<std::string>& q,
                               std::string first, long max_items) {
    std::string arr = "[";
    arr += first;
    long taken = 1;
    while (!q.empty() && (max_items <= 0 || taken < max_items)) {
        arr += ",";
        arr += q.front();
        q.pop_front();
        ++taken;
    }
    arr += "]";
    return arr;
}

static void reap_queue(const std::string& name) {
    auto it = queues.find(name);
    if (it != queues.end() && it->second.empty()) queues.erase(it);
}

// A value was pushed: fulfil the oldest live waiter, if any. Returns
// true when the value was consumed by a waiter.
static bool fulfil_waiter(const std::string& qname,
                          const std::string& raw_value) {
    auto wit = waiters.find(qname);
    if (wit == waiters.end()) return false;
    auto& dq = wit->second;
    while (!dq.empty()) {
        Waiter w = dq.front();
        dq.pop_front();
        auto cit = conns.find(w.fd);
        if (cit == conns.end() || cit->second.gen != w.gen)
            continue;  // connection died while parked (fd may be reused)
        Conn& c = cit->second;
        c.parked = false;
        if (w.batch) {
            auto& q = queues[qname];  // may hold later pushes; drain them
            respond_value(c, drain_burst(q, raw_value, w.max_items));
            reap_queue(qname);
        } else {
            respond_value(c, raw_value);
        }
        if (dq.empty()) waiters.erase(wit);
        return true;
    }
    waiters.erase(wit);
    return false;
}

// Expire waiters whose deadline passed; return the nearest deadline.
static double expire_waiters() {
    double nearest = -1.0;
    double now = now_mono();
    for (auto it = waiters.begin(); it != waiters.end();) {
        auto& dq = it->second;
        for (auto w = dq.begin(); w != dq.end();) {
            auto cit = conns.find(w->fd);
            if (cit == conns.end() || cit->second.gen != w->gen) {
                w = dq.erase(w);  // dead or recycled connection
                continue;
            }
            if (w->deadline <= now) {
                Conn& c = cit->second;
                c.parked = false;
                respond_value(c, w->batch ? "[]" : "null");
                w = dq.erase(w);
                continue;
            }
            if (nearest < 0 || w->deadline < nearest)
                nearest = w->deadline;
            ++w;
        }
        if (dq.empty()) it = waiters.erase(it);
        else ++it;
    }
    return nearest;
}

static double num_or(const std::map<std::string, Span>& env,
                     const char* key, double dflt) {
    auto it = env.find(key);
    if (it == env.end() || !it->second.ok()) return dflt;
    return strtod(it->second.str().c_str(), nullptr);
}

static bool str_field(const std::map<std::string, Span>& env,
                      const char* key, std::string& out) {
    auto it = env.find(key);
    if (it == env.end()) return false;
    return json_decode_string(it->second, out);
}

static void handle_request(Conn& c, const char* data, size_t n) {
    std::map<std::string, Span> env;
    std::string op;
    if (!parse_envelope(data, n, env) || !str_field(env, "op", op)) {
        respond_error(c, "malformed request");
        return;
    }

    if (op == "ping") {
        respond_value(c, "\"pong\"");
        return;
    }

    if (op == "push") {
        std::string qname;
        auto vit = env.find("value");
        if (!str_field(env, "queue", qname) || vit == env.end()) {
            respond_error(c, "push needs queue+value");
            return;
        }
        std::string raw = vit->second.str();
        if (!fulfil_waiter(qname, raw)) queues[qname].push_back(raw);
        respond_value(c, "null");
        return;
    }

    if (op == "push_many") {
        // One round-trip for a multi-queue scatter (the serving
        // fan-out: one shard frame per replica worker). The whole
        // items array is validated BEFORE anything is enqueued —
        // all-or-nothing, so a reported error never leaves a pushed
        // prefix behind (the Python client only retries per-item on
        // "unknown op", i.e. against brokers predating this op).
        auto iit = env.find("items");
        if (iit == env.end() || !iit->second.ok()) {
            respond_error(c, "push_many needs items");
            return;
        }
        std::vector<std::pair<std::string, std::string>> pushes;
        Scanner sc{iit->second.p, iit->second.p + iit->second.n};
        sc.ws();
        bool bad = (sc.p >= sc.end || *sc.p != '[');
        if (!bad) {
            ++sc.p;
            sc.ws();
            if (sc.p < sc.end && *sc.p == ']') {
                ++sc.p;  // empty array
            } else {
                while (true) {
                    Span elem = sc.skip_value();
                    std::map<std::string, Span> ienv;
                    std::string qname;
                    if (!elem.ok() ||
                        !parse_envelope(elem.p, elem.n, ienv) ||
                        !str_field(ienv, "queue", qname)) {
                        bad = true;
                        break;
                    }
                    auto vit = ienv.find("value");
                    if (vit == ienv.end() || !vit->second.ok()) {
                        bad = true;
                        break;
                    }
                    pushes.emplace_back(qname, vit->second.str());
                    sc.ws();
                    if (sc.p < sc.end && *sc.p == ',') {
                        ++sc.p;
                        continue;
                    }
                    if (sc.p < sc.end && *sc.p == ']') {
                        ++sc.p;
                        break;
                    }
                    bad = true;
                    break;
                }
            }
        }
        if (bad) {
            respond_error(c, "push_many items malformed");
            return;
        }
        for (auto& pr : pushes)
            if (!fulfil_waiter(pr.first, pr.second))
                queues[pr.first].push_back(pr.second);
        respond_value(c, "null");
        return;
    }

    if (op == "pop" || op == "pop_all") {
        std::string qname;
        if (!str_field(env, "queue", qname)) {
            respond_error(c, "pop needs queue");
            return;
        }
        bool batch = (op == "pop_all");
        long max_items = (long)num_or(env, "max_items", 0);
        double timeout = num_or(env, "timeout", 0.0);
        auto it = queues.find(qname);
        if (it != queues.end() && !it->second.empty()) {
            auto& q = it->second;
            std::string first = q.front();
            q.pop_front();
            if (batch) respond_value(c, drain_burst(q, first, max_items));
            else respond_value(c, first);
            reap_queue(qname);
            return;
        }
        if (timeout <= 0.0) {
            respond_value(c, batch ? "[]" : "null");
            return;
        }
        waiters[qname].push_back(
            Waiter{c.fd, c.gen, now_mono() + timeout, batch, max_items});
        c.parked = true;  // response deferred
        return;
    }

    if (op == "qlen") {
        std::string qname;
        if (!str_field(env, "queue", qname)) {
            respond_error(c, "qlen needs queue");
            return;
        }
        auto it = queues.find(qname);
        size_t len = (it == queues.end()) ? 0 : it->second.size();
        respond_value(c, std::to_string(len));
        return;
    }

    if (op == "qdel") {
        std::string qname;
        if (!str_field(env, "queue", qname)) {
            respond_error(c, "qdel needs queue");
            return;
        }
        queues.erase(qname);
        respond_value(c, "null");
        return;
    }

    if (op == "set") {
        std::string key;
        auto vit = env.find("value");
        if (!str_field(env, "key", key) || vit == env.end()) {
            respond_error(c, "set needs key+value");
            return;
        }
        kv[key] = vit->second.str();
        respond_value(c, "null");
        return;
    }

    if (op == "get") {
        std::string key;
        if (!str_field(env, "key", key)) {
            respond_error(c, "get needs key");
            return;
        }
        auto it = kv.find(key);
        respond_value(c, it == kv.end() ? "null" : it->second);
        return;
    }

    if (op == "del") {
        std::string key;
        if (!str_field(env, "key", key)) {
            respond_error(c, "del needs key");
            return;
        }
        kv.erase(key);
        respond_value(c, "null");
        return;
    }

    if (op == "keys") {
        std::string prefix;
        str_field(env, "prefix", prefix);
        std::string arr = "[";
        bool first = true;
        for (auto& e : kv) {
            if (e.first.compare(0, prefix.size(), prefix) != 0) continue;
            if (!first) arr += ",";
            json_encode_string(e.first, arr);
            first = false;
        }
        arr += "]";
        respond_value(c, arr);
        return;
    }

    respond_error(c, "unknown op: " + op);
}

// ---------------------------------------------------------------------------
// Event loop
// ---------------------------------------------------------------------------

static void close_conn(int fd) {
    close(fd);
    conns.erase(fd);
    // Waiters referencing this fd are skipped lazily in fulfil/expire.
}

static bool flush_writes(Conn& c) {
    while (!c.wbuf.empty()) {
        ssize_t k = send(c.fd, c.wbuf.data(), c.wbuf.size(), MSG_NOSIGNAL);
        if (k > 0) {
            c.wbuf.erase(0, (size_t)k);
            continue;
        }
        if (k < 0 && (errno == EAGAIN || errno == EWOULDBLOCK)) return true;
        return false;  // peer gone
    }
    return true;
}

static bool read_conn(Conn& c) {
    char buf[65536];
    while (true) {
        ssize_t k = recv(c.fd, buf, sizeof buf, 0);
        if (k > 0) {
            c.rbuf.append(buf, (size_t)k);
            if (c.rbuf.size() > MAX_FRAME + 4) return false;
            continue;
        }
        if (k == 0) return false;  // closed
        if (errno == EAGAIN || errno == EWOULDBLOCK) break;
        return false;
    }
    // Process complete frames.
    while (c.rbuf.size() >= 4) {
        uint32_t len;
        memcpy(&len, c.rbuf.data(), 4);
        len = ntohl(len);
        if (len > MAX_FRAME) return false;
        if (c.rbuf.size() < 4 + (size_t)len) break;
        handle_request(c, c.rbuf.data() + 4, len);
        c.rbuf.erase(0, 4 + (size_t)len);
        if (c.parked) break;  // synchronous protocol: no pipelining
    }
    return flush_writes(c);
}

int main(int argc, char** argv) {
    const char* host = (argc > 1) ? argv[1] : "127.0.0.1";
    int port = (argc > 2) ? atoi(argv[2]) : 0;
    signal(SIGPIPE, SIG_IGN);

    int lfd = socket(AF_INET, SOCK_STREAM, 0);
    if (lfd < 0) {
        perror("socket");
        return 1;
    }
    int one = 1;
    setsockopt(lfd, SOL_SOCKET, SO_REUSEADDR, &one, sizeof one);
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_port = htons((uint16_t)port);
    if (inet_pton(AF_INET, host, &addr.sin_addr) != 1) {
        fprintf(stderr, "bad host %s\n", host);
        return 1;
    }
    if (bind(lfd, (sockaddr*)&addr, sizeof addr) < 0) {
        perror("bind");
        return 1;
    }
    if (listen(lfd, 128) < 0) {
        perror("listen");
        return 1;
    }
    int lfl = fcntl(lfd, F_GETFL, 0);
    fcntl(lfd, F_SETFL, lfl | O_NONBLOCK);
    socklen_t alen = sizeof addr;
    getsockname(lfd, (sockaddr*)&addr, &alen);
    printf("PORT %d\n", (int)ntohs(addr.sin_port));
    fflush(stdout);

    while (true) {
        // Expire first: it queues timeout responses, which the pollfd
        // build below must see as pending writes (POLLOUT).
        double nearest = expire_waiters();
        std::vector<pollfd> pfds;
        pfds.push_back({lfd, POLLIN, 0});
        for (auto& e : conns) {
            short ev = POLLIN;
            if (!e.second.wbuf.empty()) ev |= POLLOUT;
            pfds.push_back({e.first, ev, 0});
        }
        int tmo = -1;
        if (nearest >= 0) {
            double dt = nearest - now_mono();
            tmo = dt <= 0 ? 0 : (int)(dt * 1000.0) + 1;
        }
        int rc = poll(pfds.data(), pfds.size(), tmo);
        if (rc < 0) {
            if (errno == EINTR) continue;
            perror("poll");
            return 1;
        }
        if (pfds[0].revents & POLLIN) {
            while (true) {
                int cfd = accept(lfd, nullptr, nullptr);
                if (cfd < 0) break;
                int fl = fcntl(cfd, F_GETFL, 0);
                fcntl(cfd, F_SETFL, fl | O_NONBLOCK);
                setsockopt(cfd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof one);
                Conn c;
                c.fd = cfd;
                c.gen = next_gen++;
                conns[cfd] = c;
            }
        }
        for (size_t i = 1; i < pfds.size(); ++i) {
            int fd = pfds[i].fd;
            auto it = conns.find(fd);
            if (it == conns.end()) continue;
            Conn& c = it->second;
            bool ok = true;
            if (pfds[i].revents & (POLLERR | POLLHUP | POLLNVAL)) ok = false;
            if (ok && (pfds[i].revents & POLLOUT)) ok = flush_writes(c);
            if (ok && (pfds[i].revents & POLLIN)) ok = read_conn(c);
            if (!ok) close_conn(fd);
        }
    }
}
