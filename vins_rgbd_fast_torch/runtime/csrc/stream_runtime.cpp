// Native sensor-stream runtime of the port (a copy of the JAX package's
// runtime/csrc/stream_runtime.cpp: the code below this comment is the
// same byte for byte, and tests/test_torch_runtime.py holds it so).
//
// The host dataflow the reference runs inside its ROS nodelet
// (vins_estimator/src/estimator_nodelet.cpp): message ring buffers, RGB-D
// stamp pairing (±3 ms, :209-225), frontend/publish frequency gates
// (:265-286), stream discontinuity detection (:243-262), IMU disorder
// handling (:110-114) and fixed-capacity IMU interval assembly
// (getIMUInterval, :1913-1943), behind a minimal C ABI used through ctypes.
// Payload arrays stay on the Python side (the runtime deals in stamps and
// payload ids).
//
// Build: g++ -O2 -shared -fPIC -std=c++17 stream_runtime.cpp -o libvins_runtime.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <vector>

namespace {

struct Stamped {
    double t;
    int64_t payload;
};

struct ImuSample {
    double t;
    double acc[3];
    double gyr[3];
};

struct StreamCtx {
    // config
    double frontend_freq = 20.0;
    double publish_freq = 10.0;
    double pair_tol = 0.003;
    double gap_reset = 1.0;

    // buffers
    std::deque<Stamped> img_buf;
    std::deque<Stamped> depth_buf;
    std::deque<ImuSample> imu_buf;
    std::mutex m;

    // pairing state
    bool has_last_image = false;
    double last_image_time = 0.0;
    bool has_first = false;
    double first_image_time = 0.0;
    int pub_count = 0;
    bool reset_flag = false;
    double last_imu_time = -1e300;
};

}  // namespace

extern "C" {

void* vins_stream_create(double frontend_freq, double publish_freq,
                         double pair_tol, double gap_reset) {
    auto* ctx = new StreamCtx();
    ctx->frontend_freq = frontend_freq;
    ctx->publish_freq = publish_freq;
    ctx->pair_tol = pair_tol;
    ctx->gap_reset = gap_reset;
    return ctx;
}

void vins_stream_destroy(void* p) { delete static_cast<StreamCtx*>(p); }

void vins_stream_push_image(void* p, double t, int64_t payload) {
    auto* ctx = static_cast<StreamCtx*>(p);
    std::lock_guard<std::mutex> lk(ctx->m);
    ctx->img_buf.push_back({t, payload});
}

void vins_stream_push_depth(void* p, double t, int64_t payload) {
    auto* ctx = static_cast<StreamCtx*>(p);
    std::lock_guard<std::mutex> lk(ctx->m);
    ctx->depth_buf.push_back({t, payload});
}

// returns 1 if accepted, 0 if dropped (disordered, :110-114)
int vins_stream_push_imu(void* p, double t, const double* acc, const double* gyr) {
    auto* ctx = static_cast<StreamCtx*>(p);
    std::lock_guard<std::mutex> lk(ctx->m);
    if (t <= ctx->last_imu_time) return 0;
    ctx->last_imu_time = t;
    ImuSample s;
    s.t = t;
    std::memcpy(s.acc, acc, 3 * sizeof(double));
    std::memcpy(s.gyr, gyr, 3 * sizeof(double));
    ctx->imu_buf.push_back(s);
    return 1;
}

int vins_stream_imu_available(void* p, double t) {
    auto* ctx = static_cast<StreamCtx*>(p);
    std::lock_guard<std::mutex> lk(ctx->m);
    return (!ctx->imu_buf.empty() && ctx->imu_buf.back().t >= t) ? 1 : 0;
}

// Pops the next paired + gated frame.
// out: [t, img_payload, depth_payload, publish, reset]
// returns 1 on success, 0 if no frame available.
int vins_stream_next_frame(void* p, double* out_t, int64_t* out_img,
                           int64_t* out_depth, int* out_publish, int* out_reset) {
    auto* ctx = static_cast<StreamCtx*>(p);
    std::lock_guard<std::mutex> lk(ctx->m);
    while (true) {
        // pair by stamp within tolerance (:209-225)
        Stamped img{0, 0}, dep{0, 0};
        bool paired = false;
        while (!ctx->img_buf.empty() && !ctx->depth_buf.empty()) {
            img = ctx->img_buf.front();
            dep = ctx->depth_buf.front();
            if (img.t < dep.t - ctx->pair_tol) {
                ctx->img_buf.pop_front();
            } else if (dep.t < img.t - ctx->pair_tol) {
                ctx->depth_buf.pop_front();
            } else {
                ctx->img_buf.pop_front();
                ctx->depth_buf.pop_front();
                paired = true;
                break;
            }
        }
        if (!paired) return 0;

        const double t = img.t;
        // discontinuity detection (:243-262)
        if (ctx->has_last_image &&
            (t < ctx->last_image_time || t - ctx->last_image_time > ctx->gap_reset)) {
            ctx->reset_flag = true;
            ctx->has_first = false;
            ctx->pub_count = 0;
        }
        ctx->has_last_image = true;
        ctx->last_image_time = t;
        if (!ctx->has_first) {
            ctx->has_first = true;
            ctx->first_image_time = t;
        }

        // frontend input gate (:265-271)
        if (ctx->frontend_freq > 0) {
            double elapsed = t - ctx->first_image_time;
            if (elapsed > 0 &&
                (ctx->pub_count + 1) / elapsed > ctx->frontend_freq * 1.15) {
                continue;  // skip frame
            }
        }
        // publish gate (:274-286)
        int publish = 1;
        if (ctx->publish_freq > 0) {
            double elapsed = std::max(t - ctx->first_image_time, 1e-9);
            double rate = ctx->pub_count / elapsed;
            publish = rate <= ctx->publish_freq ? 1 : 0;
            if (publish &&
                std::fabs(rate - ctx->publish_freq) < 0.01 * ctx->publish_freq) {
                ctx->first_image_time = t;
                ctx->pub_count = 0;
            }
        }
        if (publish) ctx->pub_count++;

        *out_t = t;
        *out_img = img.payload;
        *out_depth = dep.payload;
        *out_publish = publish;
        *out_reset = ctx->reset_flag ? 1 : 0;
        ctx->reset_flag = false;
        return 1;
    }
}

// Assemble the fixed-capacity zero-padded IMU interval (t0, t1]
// (getIMUInterval + processIMU dt conventions, estimator.cpp:186-199,
// 1913-1943).  dts: [maxi], acc/gyr: [(maxi+1) * 3] row-major.
// Returns the number of integration steps written.
int vins_stream_collect_interval(void* p, double t0, double t1, int maxi,
                                 double* dts, double* acc, double* gyr) {
    auto* ctx = static_cast<StreamCtx*>(p);
    std::lock_guard<std::mutex> lk(ctx->m);
    std::memset(dts, 0, maxi * sizeof(double));
    std::memset(acc, 0, (maxi + 1) * 3 * sizeof(double));
    std::memset(gyr, 0, (maxi + 1) * 3 * sizeof(double));

    auto& buf = ctx->imu_buf;
    // drop samples at or before t0, keeping the last as the boundary value
    while (buf.size() > 1 && buf[1].t <= t0) buf.pop_front();
    if (buf.empty()) return 0;

    std::memcpy(acc, buf[0].acc, 3 * sizeof(double));
    std::memcpy(gyr, buf[0].gyr, 3 * sizeof(double));
    double t_prev = t0;
    int k = 0;
    size_t idx = 1;
    while (idx < buf.size() && k < maxi) {
        const auto& s = buf[idx];
        if (s.t >= t1) break;
        dts[k] = s.t - t_prev;
        std::memcpy(acc + 3 * (k + 1), s.acc, 3 * sizeof(double));
        std::memcpy(gyr + 3 * (k + 1), s.gyr, 3 * sizeof(double));
        t_prev = s.t;
        ++k;
        ++idx;
    }
    if (k < maxi && idx < buf.size()) {
        const auto& s = buf[idx];
        dts[k] = t1 - t_prev;
        std::memcpy(acc + 3 * (k + 1), s.acc, 3 * sizeof(double));
        std::memcpy(gyr + 3 * (k + 1), s.gyr, 3 * sizeof(double));
        ++k;
    }
    // replicate the last sample into the padding (dt = 0 ⇒ exact no-op)
    for (int j = k + 1; j <= maxi; ++j) {
        std::memcpy(acc + 3 * j, acc + 3 * k, 3 * sizeof(double));
        std::memcpy(gyr + 3 * j, gyr + 3 * k, 3 * sizeof(double));
    }
    // keep the boundary sample for the next interval
    while (buf.size() > 1 && buf[1].t < t1) buf.pop_front();
    return k;
}

}  // extern "C"
