// _mfi_native: host-side frame data-path primitives.
//
// The reference's hot host paths are C inside mpv: mp_image plane copies
// (video/mp_image.c), the recycling frame pool (video/mp_image_pool.c), and
// libswscale repacks (video/repack.c).  This extension is the rebuild's
// native equivalent for the host that feeds the card: NV12 chroma
// (de)interleave and planar I420<->biplanar conversions run as tight C++
// loops over the buffer protocol (numpy strided copies cannot keep up at
// 4K120 rates), plus an aligned recycling buffer pool.
//
// Built at first use by native/__init__.py (one g++ process over the four
// sources) against the CPython C API only.

#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

struct BufView {
    Py_buffer view{};
    bool ok = false;
    ~BufView() {
        if (ok) PyBuffer_Release(&view);
    }
    bool acquire(PyObject* obj, int flags) {
        if (PyObject_GetBuffer(obj, &view, flags) != 0) return false;
        ok = true;
        return true;
    }
};

// interleave_chroma(u, v, out): planar u,v (h, w) -> out (h, 2w) as UVUV...
template <typename T>
void interleave_rows(const T* u, const T* v, T* out, Py_ssize_t h,
                     Py_ssize_t w, Py_ssize_t su, Py_ssize_t sv,
                     Py_ssize_t so) {
    for (Py_ssize_t y = 0; y < h; y++) {
        const T* ur = u + y * su;
        const T* vr = v + y * sv;
        T* orow = out + y * so;
        for (Py_ssize_t x = 0; x < w; x++) {
            orow[2 * x] = ur[x];
            orow[2 * x + 1] = vr[x];
        }
    }
}

template <typename T>
void deinterleave_rows(const T* uv, T* u, T* v, Py_ssize_t h, Py_ssize_t w,
                       Py_ssize_t suv, Py_ssize_t su, Py_ssize_t sv) {
    for (Py_ssize_t y = 0; y < h; y++) {
        const T* row = uv + y * suv;
        T* ur = u + y * su;
        T* vr = v + y * sv;
        for (Py_ssize_t x = 0; x < w; x++) {
            ur[x] = row[2 * x];
            vr[x] = row[2 * x + 1];
        }
    }
}

// Common entry: validates 2-D contiguous-ish buffers of 1- or 2-byte items.
static bool check2d(const Py_buffer& b, const char* name) {
    if (b.ndim != 2) {
        PyErr_Format(PyExc_ValueError, "%s must be 2-D", name);
        return false;
    }
    if (b.itemsize != 1 && b.itemsize != 2) {
        PyErr_Format(PyExc_ValueError, "%s must be uint8/uint16", name);
        return false;
    }
    if (b.strides[1] != b.itemsize) {
        PyErr_Format(PyExc_ValueError, "%s rows must be contiguous", name);
        return false;
    }
    return true;
}

static PyObject* py_interleave(PyObject*, PyObject* args) {
    PyObject *uo, *vo, *oo;
    if (!PyArg_ParseTuple(args, "OOO", &uo, &vo, &oo)) return nullptr;
    BufView u, v, o;
    if (!u.acquire(uo, PyBUF_RECORDS_RO) || !v.acquire(vo, PyBUF_RECORDS_RO)
        || !o.acquire(oo, PyBUF_RECORDS))
        return nullptr;
    if (!check2d(u.view, "u") || !check2d(v.view, "v") || !check2d(o.view, "out"))
        return nullptr;
    Py_ssize_t h = u.view.shape[0], w = u.view.shape[1];
    if (v.view.shape[0] != h || v.view.shape[1] != w ||
        o.view.shape[0] != h || o.view.shape[1] != 2 * w ||
        u.view.itemsize != v.view.itemsize ||
        u.view.itemsize != o.view.itemsize) {
        PyErr_SetString(PyExc_ValueError, "shape/itemsize mismatch");
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS
    if (u.view.itemsize == 1) {
        interleave_rows((const uint8_t*)u.view.buf, (const uint8_t*)v.view.buf,
                        (uint8_t*)o.view.buf, h, w, u.view.strides[0],
                        v.view.strides[0], o.view.strides[0]);
    } else {
        interleave_rows((const uint16_t*)u.view.buf,
                        (const uint16_t*)v.view.buf, (uint16_t*)o.view.buf, h,
                        w, u.view.strides[0] / 2, v.view.strides[0] / 2,
                        o.view.strides[0] / 2);
    }
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

static PyObject* py_deinterleave(PyObject*, PyObject* args) {
    PyObject *uvo, *uo, *vo;
    if (!PyArg_ParseTuple(args, "OOO", &uvo, &uo, &vo)) return nullptr;
    BufView uv, u, v;
    if (!uv.acquire(uvo, PyBUF_RECORDS_RO) || !u.acquire(uo, PyBUF_RECORDS)
        || !v.acquire(vo, PyBUF_RECORDS))
        return nullptr;
    if (!check2d(uv.view, "uv") || !check2d(u.view, "u") || !check2d(v.view, "v"))
        return nullptr;
    Py_ssize_t h = u.view.shape[0], w = u.view.shape[1];
    if (v.view.shape[0] != h || v.view.shape[1] != w ||
        uv.view.shape[0] != h || uv.view.shape[1] != 2 * w ||
        uv.view.itemsize != u.view.itemsize ||
        uv.view.itemsize != v.view.itemsize) {
        PyErr_SetString(PyExc_ValueError, "shape/itemsize mismatch");
        return nullptr;
    }
    Py_BEGIN_ALLOW_THREADS
    if (u.view.itemsize == 1) {
        deinterleave_rows((const uint8_t*)uv.view.buf, (uint8_t*)u.view.buf,
                          (uint8_t*)v.view.buf, h, w, uv.view.strides[0],
                          u.view.strides[0], v.view.strides[0]);
    } else {
        deinterleave_rows((const uint16_t*)uv.view.buf, (uint16_t*)u.view.buf,
                          (uint16_t*)v.view.buf, h, w, uv.view.strides[0] / 2,
                          u.view.strides[0] / 2, v.view.strides[0] / 2);
    }
    Py_END_ALLOW_THREADS
    Py_RETURN_NONE;
}

// ---------------------------------------------------------------------
// BufferPool: recycling aligned allocator (mp_image_pool analog,
// video/mp_image_pool.c -- HopperRender draws every output frame from one,
// vf_HopperRender.c:385,699).
// ---------------------------------------------------------------------

struct PoolEntry {
    void* ptr;
    size_t size;
};

struct PoolObject {
    PyObject_HEAD
    std::vector<PoolEntry>* free_list;
    size_t max_entries;
    size_t hits, misses;
};

static PyObject* pool_get(PyObject* self_, PyObject* args) {
    PoolObject* self = (PoolObject*)self_;
    Py_ssize_t size;
    if (!PyArg_ParseTuple(args, "n", &size)) return nullptr;
    void* ptr = nullptr;
    for (size_t i = 0; i < self->free_list->size(); i++) {
        if ((*self->free_list)[i].size == (size_t)size) {
            ptr = (*self->free_list)[i].ptr;
            self->free_list->erase(self->free_list->begin() + i);
            self->hits++;
            break;
        }
    }
    if (!ptr) {
        if (posix_memalign(&ptr, 128, (size_t)size) != 0)
            return PyErr_NoMemory();
        self->misses++;
    }
    // hand out as a writable memoryview; the Python wrapper returns it via
    // give_back() when the frame is recycled
    return PyMemoryView_FromMemory((char*)ptr, size, PyBUF_WRITE);
}

static PyObject* pool_give_back(PyObject* self_, PyObject* args) {
    PoolObject* self = (PoolObject*)self_;
    PyObject* mv;
    if (!PyArg_ParseTuple(args, "O", &mv)) return nullptr;
    if (!PyMemoryView_Check(mv)) {
        PyErr_SetString(PyExc_TypeError, "expected a memoryview from get()");
        return nullptr;
    }
    Py_buffer* b = PyMemoryView_GET_BUFFER(mv);
    if (self->free_list->size() >= self->max_entries) {
        free(b->buf);
    } else {
        self->free_list->push_back({b->buf, (size_t)b->len});
    }
    Py_RETURN_NONE;
}

static PyObject* pool_stats(PyObject* self_, PyObject*) {
    PoolObject* self = (PoolObject*)self_;
    return Py_BuildValue("{s:n,s:n,s:n}", "hits", (Py_ssize_t)self->hits,
                         "misses", (Py_ssize_t)self->misses, "free",
                         (Py_ssize_t)self->free_list->size());
}

static void pool_dealloc(PyObject* self_) {
    PoolObject* self = (PoolObject*)self_;
    for (auto& e : *self->free_list) free(e.ptr);
    delete self->free_list;
    Py_TYPE(self)->tp_free(self_);
}

static PyObject* pool_new(PyTypeObject* type, PyObject* args, PyObject*) {
    Py_ssize_t max_entries = 16;
    if (!PyArg_ParseTuple(args, "|n", &max_entries)) return nullptr;
    PoolObject* self = (PoolObject*)type->tp_alloc(type, 0);
    if (!self) return nullptr;
    self->free_list = new std::vector<PoolEntry>();
    self->max_entries = (size_t)max_entries;
    self->hits = self->misses = 0;
    return (PyObject*)self;
}

static PyMethodDef pool_methods[] = {
    {"get", pool_get, METH_VARARGS,
     "get(nbytes) -> memoryview over a 128-byte-aligned buffer"},
    {"give_back", pool_give_back, METH_VARARGS,
     "return a buffer obtained from get() to the pool"},
    {"stats", pool_stats, METH_NOARGS, "pool hit/miss/free counts"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject PoolType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

// ---------------------------------------------------------------------
// Y4MRing: C++ demuxer thread for y4m payloads (demux-thread analog,
// demux/demux.c:2549).  Python parses the stream header and registers
// recycled frame buffers (push_free); this thread reads each FRAME record
// straight into a registered luma buffer, repacks planar U,V into the
// interleaved NV12/P010 chroma buffer (with the 10-bit << 6 shift fused
// into the repack), and queues the filled slot for pop().  All file IO and
// repack work runs without the GIL on a dedicated thread, so decode
// overlaps device compute like the reference's demux + decode threads.
// ---------------------------------------------------------------------

struct RingSlot {
    Py_buffer y;
    Py_buffer uv;
    long tag;
};

// source layouts the reader thread understands:
//   LAYOUT_Y4M      sequential FRAME-marker stream (y4m), read()
//   LAYOUT_IDX_I420 container-indexed planar I420 payloads, pread()
//   LAYOUT_IDX_NV12 container-indexed NV12 payloads, pread()
// The indexed modes serve MKV (V_UNCOMPRESSED) and MP4/MOV (raw video)
// demuxing: Python parses the container once into a frame-offset table
// (io/mkv.py, io/mp4.py) and this thread streams the payloads into
// recycled buffers -- the same zero-alloc, no-GIL data path as y4m.
enum { LAYOUT_Y4M = 0, LAYOUT_IDX_I420 = 1, LAYOUT_IDX_NV12 = 2 };

struct RingObject {
    PyObject_HEAD
    int fd;
    int itemsize;   // 1 (NV12) or 2 (P010)
    int shift;      // 10-bit -> P010 top-bits shift (6), else 0
    int layout;     // LAYOUT_* above
    size_t y_items, c_items;  // samples: w*h and (w/2)*(h/2)
    std::mutex* mu;
    std::condition_variable* cv;
    std::deque<RingSlot>* free_q;
    std::deque<RingSlot>* filled_q;
    std::thread* thread;
    bool stop_flag, eof;
    std::string* err;
    uint8_t* scratch;        // planar u+v staging (2 * c_items * itemsize)
    long long frames_read;
    std::vector<long long>* offsets;  // indexed modes: payload byte offsets
    size_t next_idx;                  // reader-thread-only cursor
};

static bool read_full(int fd, uint8_t* dst, size_t n) {
    size_t got = 0;
    while (got < n) {
        ssize_t r = read(fd, dst + got, n - got);
        if (r <= 0) return false;
        got += r;
    }
    return true;
}

static bool pread_full(int fd, uint8_t* dst, size_t n, long long off) {
    size_t got = 0;
    while (got < n) {
        ssize_t r = pread(fd, dst + got, n - got, (off_t)(off + got));
        if (r <= 0) return false;
        got += r;
    }
    return true;
}

// 1 = frame follows, 0 = clean EOF, -1 = stream corrupt
static int read_marker(int fd) {
    std::string line;
    char c;
    do {
        if (read(fd, &c, 1) <= 0) return line.empty() ? 0 : -1;
        line.push_back(c);
        if (line.size() > 256) return -1;
    } while (c != '\n');
    return line.compare(0, 5, "FRAME") == 0 ? 1 : -1;
}

template <typename T>
static void interleave_shift(const T* u, const T* v, T* out, size_t n,
                             int shift) {
    for (size_t i = 0; i < n; i++) {
        out[2 * i] = (T)(u[i] << shift);
        out[2 * i + 1] = (T)(v[i] << shift);
    }
}

static void ring_reader(RingObject* r) {
    for (;;) {
        RingSlot slot;
        {
            std::unique_lock<std::mutex> l(*r->mu);
            r->cv->wait(l, [r] { return r->stop_flag || !r->free_q->empty(); });
            if (r->stop_flag) return;
            slot = r->free_q->front();
            r->free_q->pop_front();
        }
        int m;
        bool ok = false;
        const size_t ybytes = r->y_items * r->itemsize;
        const size_t cbytes = r->c_items * r->itemsize;
        if (r->layout == LAYOUT_Y4M) {
            m = read_marker(r->fd);
            if (m == 1) {
                ok = read_full(r->fd, (uint8_t*)slot.y.buf, ybytes) &&
                     read_full(r->fd, r->scratch, 2 * cbytes);
                if (ok) {
                    if (r->itemsize == 1) {
                        interleave_shift((const uint8_t*)r->scratch,
                                         (const uint8_t*)r->scratch + cbytes,
                                         (uint8_t*)slot.uv.buf, r->c_items, 0);
                    } else {
                        if (r->shift) {
                            uint16_t* yb = (uint16_t*)slot.y.buf;
                            for (size_t i = 0; i < r->y_items; i++)
                                yb[i] = (uint16_t)(yb[i] << r->shift);
                        }
                        interleave_shift((const uint16_t*)r->scratch,
                                         (const uint16_t*)r->scratch + r->c_items,
                                         (uint16_t*)slot.uv.buf, r->c_items,
                                         r->shift);
                    }
                }
            }
        } else {
            // container-indexed payloads (MKV/MP4): pread at the demuxed
            // offset -- never moves the fd position, so Python-side index
            // parsing and this thread share the fd safely
            size_t i = r->next_idx;
            if (i >= r->offsets->size()) {
                m = 0;  // clean end of index
            } else {
                r->next_idx = i + 1;
                const long long off = (*r->offsets)[i];
                ok = pread_full(r->fd, (uint8_t*)slot.y.buf, ybytes, off);
                if (ok && r->layout == LAYOUT_IDX_NV12) {
                    ok = pread_full(r->fd, (uint8_t*)slot.uv.buf, 2 * cbytes,
                                    off + (long long)ybytes);
                } else if (ok) {   // LAYOUT_IDX_I420
                    ok = pread_full(r->fd, r->scratch, 2 * cbytes,
                                    off + (long long)ybytes);
                    if (ok)
                        interleave_shift((const uint8_t*)r->scratch,
                                         (const uint8_t*)r->scratch + cbytes,
                                         (uint8_t*)slot.uv.buf, r->c_items, 0);
                }
                m = ok ? 1 : -1;
            }
        }
        std::lock_guard<std::mutex> l(*r->mu);
        if (!ok) {
            if (m == -1)
                *r->err = r->layout == LAYOUT_Y4M
                              ? "corrupt y4m FRAME record"
                              : "short/unreadable indexed frame payload";
            r->eof = true;
            r->free_q->push_back(slot);  // buffers released at stop/dealloc
            r->cv->notify_all();
            return;
        }
        r->frames_read++;
        r->filled_q->push_back(slot);
        r->cv->notify_all();
    }
}

static bool check_plane(const Py_buffer& b, size_t want_bytes,
                        const char* name) {
    if (!PyBuffer_IsContiguous(&b, 'C')) {
        PyErr_Format(PyExc_ValueError, "%s buffer must be C-contiguous", name);
        return false;
    }
    if ((size_t)b.len != want_bytes) {
        PyErr_Format(PyExc_ValueError, "%s buffer is %zd bytes, need %zu",
                     name, b.len, want_bytes);
        return false;
    }
    return true;
}

static PyObject* ring_push_free(PyObject* self_, PyObject* args) {
    RingObject* self = (RingObject*)self_;
    long tag;
    PyObject *yo, *uvo;
    if (!PyArg_ParseTuple(args, "lOO", &tag, &yo, &uvo)) return nullptr;
    RingSlot slot;
    slot.tag = tag;
    if (PyObject_GetBuffer(yo, &slot.y, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) != 0)
        return nullptr;
    if (PyObject_GetBuffer(uvo, &slot.uv, PyBUF_C_CONTIGUOUS | PyBUF_WRITABLE) != 0) {
        PyBuffer_Release(&slot.y);
        return nullptr;
    }
    if (!check_plane(slot.y, self->y_items * self->itemsize, "y") ||
        !check_plane(slot.uv, 2 * self->c_items * self->itemsize, "uv")) {
        PyBuffer_Release(&slot.y);
        PyBuffer_Release(&slot.uv);
        return nullptr;
    }
    {
        std::lock_guard<std::mutex> l(*self->mu);
        if (self->stop_flag) {
            PyBuffer_Release(&slot.y);
            PyBuffer_Release(&slot.uv);
            PyErr_SetString(PyExc_RuntimeError, "ring is stopped");
            return nullptr;
        }
        self->free_q->push_back(slot);
        self->cv->notify_all();
    }
    Py_RETURN_NONE;
}

static PyObject* ring_pop(PyObject* self_, PyObject*) {
    RingObject* self = (RingObject*)self_;
    bool have = false;
    RingSlot slot{};
    Py_BEGIN_ALLOW_THREADS {
        std::unique_lock<std::mutex> l(*self->mu);
        self->cv->wait(l, [self] {
            return !self->filled_q->empty() || self->eof || self->stop_flag;
        });
        if (!self->filled_q->empty()) {
            slot = self->filled_q->front();
            self->filled_q->pop_front();
            have = true;
        }
    }
    Py_END_ALLOW_THREADS
    if (!have) {
        if (!self->err->empty()) {
            PyErr_SetString(PyExc_RuntimeError, self->err->c_str());
            return nullptr;
        }
        Py_RETURN_NONE;  // clean EOF, everything drained
    }
    long tag = slot.tag;
    PyBuffer_Release(&slot.y);
    PyBuffer_Release(&slot.uv);
    return PyLong_FromLong(tag);
}

static void ring_stop_impl(RingObject* self) {
    {
        std::lock_guard<std::mutex> l(*self->mu);
        self->stop_flag = true;
        self->cv->notify_all();
    }
    if (self->thread) {
        if (self->thread->joinable()) {
            Py_BEGIN_ALLOW_THREADS
            self->thread->join();
            Py_END_ALLOW_THREADS
        }
        delete self->thread;
        self->thread = nullptr;
    }
    // release every still-registered buffer (requires the GIL; thread dead)
    for (auto* q : {self->free_q, self->filled_q}) {
        for (auto& s : *q) {
            PyBuffer_Release(&s.y);
            PyBuffer_Release(&s.uv);
        }
        q->clear();
    }
}

static PyObject* ring_stop(PyObject* self_, PyObject*) {
    ring_stop_impl((RingObject*)self_);
    Py_RETURN_NONE;
}

static PyObject* ring_stats(PyObject* self_, PyObject*) {
    RingObject* self = (RingObject*)self_;
    std::lock_guard<std::mutex> l(*self->mu);
    return Py_BuildValue("{s:L,s:n,s:n,s:O}", "frames_read",
                         (long long)self->frames_read, "free",
                         (Py_ssize_t)self->free_q->size(), "filled",
                         (Py_ssize_t)self->filled_q->size(), "eof",
                         self->eof ? Py_True : Py_False);
}

static void ring_dealloc(PyObject* self_) {
    RingObject* self = (RingObject*)self_;
    ring_stop_impl(self);
    free(self->scratch);
    delete self->mu;
    delete self->cv;
    delete self->free_q;
    delete self->filled_q;
    delete self->err;
    delete self->offsets;
    Py_TYPE(self)->tp_free(self_);
}

// shared field init; returns false on allocation failure
static bool ring_init_common(RingObject* self, int fd, int width, int height,
                             int itemsize, int shift, int layout) {
    self->fd = fd;
    self->itemsize = itemsize;
    self->shift = shift;
    self->layout = layout;
    self->y_items = (size_t)width * height;
    self->c_items = (size_t)(width / 2) * (height / 2);
    self->mu = new std::mutex();
    self->cv = new std::condition_variable();
    self->free_q = new std::deque<RingSlot>();
    self->filled_q = new std::deque<RingSlot>();
    self->err = new std::string();
    self->offsets = new std::vector<long long>();
    self->stop_flag = false;
    self->eof = false;
    self->frames_read = 0;
    self->next_idx = 0;
    self->thread = nullptr;
    void* sc = nullptr;
    if (posix_memalign(&sc, 128, 2 * self->c_items * itemsize) != 0) {
        self->scratch = nullptr;
        return false;
    }
    self->scratch = (uint8_t*)sc;
    return true;
}

static PyObject* ring_new(PyTypeObject* type, PyObject* args, PyObject*) {
    int fd, width, height, itemsize, shift;
    if (!PyArg_ParseTuple(args, "iiiii", &fd, &width, &height, &itemsize,
                          &shift))
        return nullptr;
    if (width <= 0 || height <= 0 || width % 2 || height % 2 ||
        (itemsize != 1 && itemsize != 2) || shift < 0 || shift > 8) {
        PyErr_SetString(PyExc_ValueError, "bad ring geometry");
        return nullptr;
    }
    RingObject* self = (RingObject*)type->tp_alloc(type, 0);
    if (!self) return nullptr;
    if (!ring_init_common(self, fd, width, height, itemsize, shift,
                          LAYOUT_Y4M)) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    self->thread = new std::thread(ring_reader, self);
    return (PyObject*)self;
}

// IndexedRing(fd, width, height, layout, offsets): container-indexed
// variant for MKV/MP4 raw-video payloads.  `layout` is "i420" or "nv12";
// `offsets` exposes a C-contiguous int64 buffer of payload byte offsets
// (np.ascontiguousarray(..., np.int64)).  8-bit only -- both demuxers in
// scope (io/mkv.py V_UNCOMPRESSED, io/mp4.py raw fourccs) are 8-bit.
static PyObject* iring_new(PyTypeObject* type, PyObject* args, PyObject*) {
    int fd, width, height;
    const char* layout_s;
    PyObject* offsets_o;
    if (!PyArg_ParseTuple(args, "iiisO", &fd, &width, &height, &layout_s,
                          &offsets_o))
        return nullptr;
    int layout;
    if (strcmp(layout_s, "i420") == 0) layout = LAYOUT_IDX_I420;
    else if (strcmp(layout_s, "nv12") == 0) layout = LAYOUT_IDX_NV12;
    else {
        PyErr_Format(PyExc_ValueError, "unknown layout %s", layout_s);
        return nullptr;
    }
    if (width <= 0 || height <= 0 || width % 2 || height % 2) {
        PyErr_SetString(PyExc_ValueError, "bad ring geometry");
        return nullptr;
    }
    BufView off;
    if (!off.acquire(offsets_o, PyBUF_C_CONTIGUOUS)) return nullptr;
    if (off.view.len % 8 != 0) {
        PyErr_SetString(PyExc_ValueError,
                        "offsets must be an int64 buffer");
        return nullptr;
    }
    RingObject* self = (RingObject*)type->tp_alloc(type, 0);
    if (!self) return nullptr;
    if (!ring_init_common(self, fd, width, height, 1, 0, layout)) {
        Py_DECREF(self);
        return PyErr_NoMemory();
    }
    const long long* p = (const long long*)off.view.buf;
    self->offsets->assign(p, p + off.view.len / 8);
    self->thread = new std::thread(ring_reader, self);
    return (PyObject*)self;
}

static PyMethodDef ring_methods[] = {
    {"push_free", ring_push_free, METH_VARARGS,
     "push_free(tag, y, uv): register writable frame buffers for filling"},
    {"pop", ring_pop, METH_NOARGS,
     "pop() -> tag of the next filled slot, or None at EOF"},
    {"stop", ring_stop, METH_NOARGS, "stop + join the demuxer thread"},
    {"stats", ring_stats, METH_NOARGS, "frames_read/free/filled/eof"},
    {nullptr, nullptr, 0, nullptr},
};

static PyTypeObject RingType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

static PyTypeObject IndexedRingType = {
    PyVarObject_HEAD_INIT(nullptr, 0)
};

extern "C" PyObject* mfi_decode_jpeg(PyObject*, PyObject*);  // native/jpeg.cpp
extern "C" PyObject* mfi_decode_utvideo(PyObject*, PyObject*);  // native/utvideo.cpp
extern "C" PyObject* mfi_ffv1_create(PyObject*, PyObject*);  // native/ffv1.cpp
extern "C" PyObject* mfi_ffv1_reset(PyObject*, PyObject*);
extern "C" PyObject* mfi_ffv1_decode(PyObject*, PyObject*);
extern "C" PyObject* mfi_ffv1_enc_create(PyObject*, PyObject*);
extern "C" PyObject* mfi_ffv1_encode(PyObject*, PyObject*);

static PyMethodDef module_methods[] = {
    {"interleave_chroma", py_interleave, METH_VARARGS,
     "interleave_chroma(u, v, out): planar -> NV12 UV plane"},
    {"deinterleave_chroma", py_deinterleave, METH_VARARGS,
     "deinterleave_chroma(uv, u, v): NV12 UV plane -> planar"},
    {"decode_jpeg", mfi_decode_jpeg, METH_VARARGS,
     "decode_jpeg(data) -> (w, h, y, u, v): baseline JPEG -> I420 planes"},
    {"decode_utvideo", mfi_decode_utvideo, METH_VARARGS,
     "decode_utvideo(data, fourcc, w, h, slices) -> (y, u, v) planes"},
    {"ffv1_create", mfi_ffv1_create, METH_VARARGS,
     "ffv1_create(w, h) -> stateful FFV1 stream decoder capsule"},
    {"ffv1_reset", mfi_ffv1_reset, METH_VARARGS,
     "ffv1_reset(capsule): drop chained context state (after a seek)"},
    {"ffv1_decode", mfi_ffv1_decode, METH_VARARGS,
     "ffv1_decode(capsule, data) -> (bits, ((plane_bytes, w, h), ...))"},
    {"ffv1_enc_create", mfi_ffv1_enc_create, METH_VARARGS,
     "ffv1_enc_create(w, h, bits) -> stateful FFV1 encoder capsule"},
    {"ffv1_encode", mfi_ffv1_encode, METH_VARARGS,
     "ffv1_encode(capsule, y, u, v, keyframe) -> packet bytes"},
    {nullptr, nullptr, 0, nullptr},
};

static struct PyModuleDef moduledef = {
    PyModuleDef_HEAD_INIT, "_mfi_native",
    "Native host data path: NV12 repack + recycling buffer pool", -1,
    module_methods,
};

}  // namespace

PyMODINIT_FUNC PyInit__mfi_native(void) {
    PyObject* m = PyModule_Create(&moduledef);
    if (!m) return nullptr;
    PoolType.tp_name = "_mfi_native.BufferPool";
    PoolType.tp_basicsize = sizeof(PoolObject);
    PoolType.tp_flags = Py_TPFLAGS_DEFAULT;
    PoolType.tp_new = pool_new;
    PoolType.tp_dealloc = pool_dealloc;
    PoolType.tp_methods = pool_methods;
    PoolType.tp_doc = "Recycling aligned buffer pool (mp_image_pool analog)";
    if (PyType_Ready(&PoolType) < 0) return nullptr;
    Py_INCREF(&PoolType);
    PyModule_AddObject(m, "BufferPool", (PyObject*)&PoolType);
    RingType.tp_name = "_mfi_native.Y4MRing";
    RingType.tp_basicsize = sizeof(RingObject);
    RingType.tp_flags = Py_TPFLAGS_DEFAULT;
    RingType.tp_new = ring_new;
    RingType.tp_dealloc = ring_dealloc;
    RingType.tp_methods = ring_methods;
    RingType.tp_doc =
        "C++ y4m demuxer thread filling registered recycled buffers";
    if (PyType_Ready(&RingType) < 0) return nullptr;
    Py_INCREF(&RingType);
    PyModule_AddObject(m, "Y4MRing", (PyObject*)&RingType);
    IndexedRingType.tp_name = "_mfi_native.IndexedRing";
    IndexedRingType.tp_basicsize = sizeof(RingObject);
    IndexedRingType.tp_flags = Py_TPFLAGS_DEFAULT;
    IndexedRingType.tp_new = iring_new;
    IndexedRingType.tp_dealloc = ring_dealloc;
    IndexedRingType.tp_methods = ring_methods;
    IndexedRingType.tp_doc =
        "C++ pread demuxer thread over a container frame-offset index "
        "(MKV/MP4 raw video) filling registered recycled buffers";
    if (PyType_Ready(&IndexedRingType) < 0) return nullptr;
    Py_INCREF(&IndexedRingType);
    PyModule_AddObject(m, "IndexedRing", (PyObject*)&IndexedRingType);
    return m;
}
