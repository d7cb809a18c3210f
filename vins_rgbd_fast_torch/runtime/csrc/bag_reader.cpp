// Native rosbag v2.0 reader of the port (a copy of the JAX package's
// runtime/csrc/bag_reader.cpp: the code below this comment is the same
// byte for byte, and tests/test_torch_runtime.py holds it so).
//
// Parses the bag container directly, with no ROS: uncompressed chunks and
// the message types the pipeline replays (sensor_msgs/Image,
// sensor_msgs/CompressedImage, passed through opaque, and sensor_msgs/Imu).
//
// Format: http://wiki.ros.org/Bags/Format/2.0 — records of
// (header_len, header fields (name=value), data_len, data), with chunk
// records containing nested message records.
//
// Build: g++ -O2 -shared -fPIC -std=c++17 bag_reader.cpp -o libvins_bag.so

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <string>
#include <vector>

namespace {

struct Field {
    std::string name;
    std::vector<uint8_t> value;
};

static bool parse_header(const uint8_t* p, uint32_t len,
                         std::map<std::string, std::vector<uint8_t>>& out) {
    uint32_t off = 0;
    while (off + 4 <= len) {
        uint32_t flen;
        std::memcpy(&flen, p + off, 4);
        off += 4;
        if (off + flen > len) return false;
        const uint8_t* f = p + off;
        const uint8_t* eq = static_cast<const uint8_t*>(memchr(f, '=', flen));
        if (!eq) return false;
        std::string name(reinterpret_cast<const char*>(f), eq - f);
        out[name] = std::vector<uint8_t>(eq + 1, f + flen);
        off += flen;
    }
    return true;
}

template <typename T>
static T get_scalar(const std::map<std::string, std::vector<uint8_t>>& h,
                    const std::string& k, T def = T()) {
    auto it = h.find(k);
    if (it == h.end() || it->second.size() < sizeof(T)) return def;
    T v;
    std::memcpy(&v, it->second.data(), sizeof(T));
    return v;
}

struct MsgRef {
    uint32_t conn;
    uint64_t time_ns;  // canonical nanoseconds: secs * 1e9 + nsecs
    std::vector<uint8_t> data;
};

// The rosbag 'time' header field packs secs in the LOW 4 bytes and nsecs in
// the HIGH 4 bytes (little-endian pair of uint32s). Sorting the raw uint64
// would order primarily by nanoseconds and scramble replay across seconds.
static uint64_t decode_time_ns(uint64_t raw) {
    uint64_t secs = raw & 0xFFFFFFFFull;
    uint64_t nsecs = raw >> 32;
    return secs * 1000000000ull + nsecs;
}

struct BagCtx {
    FILE* f = nullptr;
    std::map<uint32_t, std::string> conn_topic;  // conn id -> topic
    std::map<uint32_t, std::string> conn_type;   // conn id -> datatype
    std::vector<MsgRef> messages;                // time-ordered
    size_t cursor = 0;
    std::string err;
};

static bool read_exact(FILE* f, void* dst, size_t n) {
    return fread(dst, 1, n, f) == n;
}

static void parse_records(BagCtx* ctx, const uint8_t* buf, size_t len);

static void parse_record(BagCtx* ctx,
                         std::map<std::string, std::vector<uint8_t>>& hdr,
                         const uint8_t* data, uint32_t dlen) {
    uint8_t op = get_scalar<uint8_t>(hdr, "op", 0);
    if (op == 0x07) {  // connection
        uint32_t conn = get_scalar<uint32_t>(hdr, "conn");
        auto t = hdr.find("topic");
        std::string topic = t == hdr.end()
                                ? ""
                                : std::string(t->second.begin(), t->second.end());
        // connection data section is another header with type info
        std::map<std::string, std::vector<uint8_t>> chdr;
        parse_header(data, dlen, chdr);
        auto ty = chdr.find("type");
        ctx->conn_topic[conn] = topic;
        ctx->conn_type[conn] =
            ty == chdr.end() ? "" : std::string(ty->second.begin(), ty->second.end());
    } else if (op == 0x02) {  // message data
        MsgRef m;
        m.conn = get_scalar<uint32_t>(hdr, "conn");
        m.time_ns = decode_time_ns(get_scalar<uint64_t>(hdr, "time"));
        m.data.assign(data, data + dlen);
        ctx->messages.push_back(std::move(m));
    } else if (op == 0x05) {  // chunk
        auto comp = hdr.find("compression");
        std::string c = comp == hdr.end()
                            ? "none"
                            : std::string(comp->second.begin(), comp->second.end());
        if (c == "none") {
            parse_records(ctx, data, dlen);
        }
        // bz2/lz4 chunks are skipped (gated feature; reference bags for
        // this system ship uncompressed)
    }
}

static void parse_records(BagCtx* ctx, const uint8_t* buf, size_t len) {
    size_t off = 0;
    while (off + 4 <= len) {
        uint32_t hlen;
        std::memcpy(&hlen, buf + off, 4);
        off += 4;
        if (off + hlen + 4 > len) break;
        std::map<std::string, std::vector<uint8_t>> hdr;
        parse_header(buf + off, hlen, hdr);
        off += hlen;
        uint32_t dlen;
        std::memcpy(&dlen, buf + off, 4);
        off += 4;
        if (off + dlen > len) break;
        parse_record(ctx, hdr, buf + off, dlen);
        off += dlen;
    }
}

}  // namespace

extern "C" {

void* vins_bag_open(const char* path) {
    auto* ctx = new BagCtx();
    ctx->f = fopen(path, "rb");
    if (!ctx->f) {
        ctx->err = "open failed";
        return ctx;
    }
    char magic[13] = {0};
    if (!read_exact(ctx->f, magic, 13) ||
        std::strncmp(magic, "#ROSBAG V2.0", 12) != 0) {
        ctx->err = "not a rosbag v2.0";
        fclose(ctx->f);
        ctx->f = nullptr;
        return ctx;
    }
    // slurp the rest of the file (bags used here are modest; a streaming
    // variant can replace this without ABI changes)
    fseek(ctx->f, 0, SEEK_END);
    long end = ftell(ctx->f);
    fseek(ctx->f, 13, SEEK_SET);
    std::vector<uint8_t> buf(end - 13);
    if (!read_exact(ctx->f, buf.data(), buf.size())) {
        ctx->err = "short read";
        return ctx;
    }
    parse_records(ctx, buf.data(), buf.size());
    std::stable_sort(ctx->messages.begin(), ctx->messages.end(),
                     [](const MsgRef& a, const MsgRef& b) {
                         return a.time_ns < b.time_ns;
                     });
    return ctx;
}

const char* vins_bag_error(void* p) {
    return static_cast<BagCtx*>(p)->err.c_str();
}

int vins_bag_num_messages(void* p) {
    return static_cast<int>(static_cast<BagCtx*>(p)->messages.size());
}

int vins_bag_num_connections(void* p) {
    return static_cast<int>(static_cast<BagCtx*>(p)->conn_topic.size());
}

// Fills topic/type for connection #i. Returns conn id or -1.
int vins_bag_connection(void* p, int i, char* topic, int topic_cap,
                        char* type, int type_cap) {
    auto* ctx = static_cast<BagCtx*>(p);
    int k = 0;
    for (auto& kv : ctx->conn_topic) {
        if (k++ == i) {
            std::strncpy(topic, kv.second.c_str(), topic_cap - 1);
            topic[topic_cap - 1] = 0;
            std::strncpy(type, ctx->conn_type[kv.first].c_str(), type_cap - 1);
            type[type_cap - 1] = 0;
            return static_cast<int>(kv.first);
        }
    }
    return -1;
}

// Message metadata: returns size, writes conn + stamp.
int vins_bag_message_info(void* p, int i, int* conn, double* stamp) {
    auto* ctx = static_cast<BagCtx*>(p);
    if (i < 0 || i >= static_cast<int>(ctx->messages.size())) return -1;
    const auto& m = ctx->messages[i];
    *conn = static_cast<int>(m.conn);
    *stamp = 1e-9 * static_cast<double>(m.time_ns);
    return static_cast<int>(m.data.size());
}

// Copies message payload into dst (caller allocates size from info).
int vins_bag_message_data(void* p, int i, uint8_t* dst, int cap) {
    auto* ctx = static_cast<BagCtx*>(p);
    if (i < 0 || i >= static_cast<int>(ctx->messages.size())) return -1;
    const auto& m = ctx->messages[i];
    int n = std::min<int>(cap, static_cast<int>(m.data.size()));
    std::memcpy(dst, m.data.data(), n);
    return n;
}

void vins_bag_close(void* p) {
    auto* ctx = static_cast<BagCtx*>(p);
    if (ctx->f) fclose(ctx->f);
    delete ctx;
}

}  // extern "C"
