// Native frame viewer for raycastworlds_tpu.
//
// The reference's only native dependency is the minifb C windowing library,
// used exclusively by the interactive `play!` loop
// (/root/reference/src/single_room.jl:488-568 via MiniFB.jl).  Accelerator
// hosts are usually headless, so the equivalent here is this small C++ library that
// turns device frames into things a headless host can show:
//   * PPM/raw writers for 0x00RRGGBB uint32 frames,
//   * a fast ANSI half-block compositor (2 vertical pixels per character
//     cell, 24-bit color) for live terminal rendering,
//   * frame differencing so an interactive loop redraws only changed cells.
//
// Exposed with a C ABI and loaded from Python via ctypes (no pybind11).
//
// Windowed path: when a display is available, rcw_window_* opens a real
// X11 window (the equivalent of the reference's minifb window,
// /root/reference/src/single_room.jl:503-565) and blits 0x00RRGGBB frames
// with XPutImage.  libX11 is loaded with dlopen at RUNTIME — no X11
// development headers are required to build, and hosts without a display
// (most accelerator hosts) degrade cleanly to the headless paths above.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>

#include <dlfcn.h>

namespace {

inline int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// Append decimal integer to buffer, returns chars written.
inline int put_int(char* out, int v) {
    char tmp[12];
    int n = snprintf(tmp, sizeof tmp, "%d", v);
    memcpy(out, tmp, n);
    return n;
}

// Append "r;g;b" for a packed 0x00RRGGBB color.
inline int put_rgb(char* out, uint32_t c) {
    int n = 0;
    n += put_int(out + n, (c >> 16) & 0xFF);
    out[n++] = ';';
    n += put_int(out + n, (c >> 8) & 0xFF);
    out[n++] = ';';
    n += put_int(out + n, c & 0xFF);
    return n;
}

}  // namespace

extern "C" {

// Write a binary PPM (P6).  Returns 0 on success.
int rcw_write_ppm(const char* path, const uint32_t* img, int h, int w) {
    FILE* f = fopen(path, "wb");
    if (!f) return 1;
    fprintf(f, "P6\n%d %d\n255\n", w, h);
    std::string row(static_cast<size_t>(w) * 3, '\0');
    for (int i = 0; i < h; ++i) {
        for (int j = 0; j < w; ++j) {
            uint32_t c = img[static_cast<size_t>(i) * w + j];
            row[3 * j + 0] = static_cast<char>((c >> 16) & 0xFF);
            row[3 * j + 1] = static_cast<char>((c >> 8) & 0xFF);
            row[3 * j + 2] = static_cast<char>(c & 0xFF);
        }
        if (fwrite(row.data(), 1, row.size(), f) != row.size()) {
            fclose(f);
            return 2;
        }
    }
    fclose(f);
    return 0;
}

// Compose an ANSI 24-bit half-block frame: each output cell shows two
// vertically adjacent pixels (upper = foreground "▀", lower = background).
// Writes a NUL-terminated escape string into `out` (capacity `cap`).
// Returns bytes written (excluding NUL), or -1 if the buffer is too small.
long rcw_ansi_render(const uint32_t* img, int h, int w, char* out, long cap) {
    // Worst case per cell ~ 44 bytes; guard conservatively inside the loop.
    long n = 0;
    const char* upper_half = "\xe2\x96\x80";  // U+2580
    for (int i = 0; i + 1 < h || i < h; i += 2) {
        for (int j = 0; j < w; ++j) {
            if (n + 64 > cap) return -1;
            uint32_t top = img[static_cast<size_t>(i) * w + j];
            uint32_t bot = (i + 1 < h) ? img[static_cast<size_t>(i + 1) * w + j] : 0;
            // \e[38;2;r;g;bm \e[48;2;r;g;bm ▀
            memcpy(out + n, "\x1b[38;2;", 7); n += 7;
            n += put_rgb(out + n, top);
            out[n++] = 'm';
            memcpy(out + n, "\x1b[48;2;", 7); n += 7;
            n += put_rgb(out + n, bot);
            out[n++] = 'm';
            memcpy(out + n, upper_half, 3); n += 3;
        }
        if (n + 8 > cap) return -1;
        memcpy(out + n, "\x1b[0m\n", 5); n += 5;
    }
    if (n + 1 > cap) return -1;
    out[n] = '\0';
    return n;
}

// Count differing pixels between two frames (cheap change detection for
// interactive redraw decisions).
long rcw_frame_diff(const uint32_t* a, const uint32_t* b, long n_pixels) {
    long d = 0;
    for (long k = 0; k < n_pixels; ++k) d += (a[k] != b[k]);
    return d;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// X11 window backend (runtime dlopen; no X11 headers at build time).
// Minimal hand-declared Xlib ABI — these struct layouts and prototypes are
// stable Xlib ABI (unchanged for decades); only the fields we touch are
// named, everything else is padding.
// ---------------------------------------------------------------------------

namespace x11 {

using Display = void;
using Window = unsigned long;
using Drawable = unsigned long;
using GC = void*;
using Visual = void;
using Atom = unsigned long;
using KeySym = unsigned long;
using Status = int;

// XEvent is a union of 24 longs; we only read the leading `type` plus the
// key/client fields at their ABI offsets via the structs below.
struct XKeyEvent {
    int type;
    unsigned long serial;
    int send_event;
    Display* display;
    Window window, root, subwindow;
    unsigned long time;
    int x, y, x_root, y_root;
    unsigned int state, keycode;
    int same_screen;
};
struct XClientMessageEvent {
    int type;
    unsigned long serial;
    int send_event;
    Display* display;
    Window window;
    Atom message_type;
    int format;
    union { char b[20]; short s[10]; long l[5]; } data;
};
union XEvent {
    int type;
    XKeyEvent xkey;
    XClientMessageEvent xclient;
    long pad[24];
};

struct XImage {
    int width, height;
    int xoffset;
    int format;  // ZPixmap = 2
    char* data;
    int byte_order;  // LSBFirst = 0
    int bitmap_unit;
    int bitmap_bit_order;
    int bitmap_pad;
    int depth;
    int bytes_per_line;
    int bits_per_pixel;
    unsigned long red_mask, green_mask, blue_mask;
    void* obdata;
    struct {
        void* create_image;
        int (*destroy_image)(XImage*);
        unsigned long (*get_pixel)(XImage*, int, int);
        int (*put_pixel)(XImage*, int, int, unsigned long);
        void* sub_image;
        void* add_pixel;
    } f;
};

constexpr int KeyPressEvt = 2;
constexpr int ClientMessageEvt = 33;
constexpr long KeyPressMask = 1L << 0;
constexpr long ExposureMask = 1L << 15;
constexpr int ZPixmap = 2;

struct Lib {
    void* handle = nullptr;
    Display* (*OpenDisplay)(const char*) = nullptr;
    int (*CloseDisplay)(Display*) = nullptr;
    int (*DefaultScreen)(Display*) = nullptr;
    Window (*RootWindow)(Display*, int) = nullptr;
    Visual* (*DefaultVisual)(Display*, int) = nullptr;
    int (*DefaultDepth)(Display*, int) = nullptr;
    GC (*DefaultGC)(Display*, int) = nullptr;
    Window (*CreateSimpleWindow)(Display*, Window, int, int, unsigned,
                                 unsigned, unsigned, unsigned long,
                                 unsigned long) = nullptr;
    int (*SelectInput)(Display*, Window, long) = nullptr;
    int (*MapWindow)(Display*, Window) = nullptr;
    int (*StoreName)(Display*, Window, const char*) = nullptr;
    int (*Sync)(Display*, int) = nullptr;
    int (*Flush)(Display*) = nullptr;
    int (*Pending)(Display*) = nullptr;
    int (*NextEvent)(Display*, XEvent*) = nullptr;
    int (*PutImage)(Display*, Drawable, GC, XImage*, int, int, int, int,
                    unsigned, unsigned) = nullptr;
    Status (*InitImage)(XImage*) = nullptr;
    KeySym (*LookupKeysym)(XKeyEvent*, int) = nullptr;
    Atom (*InternAtom)(Display*, const char*, int) = nullptr;
    Status (*SetWMProtocols)(Display*, Window, Atom*, int) = nullptr;
    int (*DestroyWindow)(Display*, Window) = nullptr;

    bool ok() const { return handle != nullptr; }
};

Lib* lib() {
    static Lib L;
    static bool tried = false;
    if (tried) return L.ok() ? &L : nullptr;
    tried = true;
    L.handle = dlopen("libX11.so.6", RTLD_LAZY | RTLD_LOCAL);
    if (!L.handle) L.handle = dlopen("libX11.so", RTLD_LAZY | RTLD_LOCAL);
    if (!L.handle) return nullptr;
    auto sym = [&](const char* n) { return dlsym(L.handle, n); };
    *reinterpret_cast<void**>(&L.OpenDisplay) = sym("XOpenDisplay");
    *reinterpret_cast<void**>(&L.CloseDisplay) = sym("XCloseDisplay");
    *reinterpret_cast<void**>(&L.DefaultScreen) = sym("XDefaultScreen");
    *reinterpret_cast<void**>(&L.RootWindow) = sym("XRootWindow");
    *reinterpret_cast<void**>(&L.DefaultVisual) = sym("XDefaultVisual");
    *reinterpret_cast<void**>(&L.DefaultDepth) = sym("XDefaultDepth");
    *reinterpret_cast<void**>(&L.DefaultGC) = sym("XDefaultGC");
    *reinterpret_cast<void**>(&L.CreateSimpleWindow) = sym("XCreateSimpleWindow");
    *reinterpret_cast<void**>(&L.SelectInput) = sym("XSelectInput");
    *reinterpret_cast<void**>(&L.MapWindow) = sym("XMapWindow");
    *reinterpret_cast<void**>(&L.StoreName) = sym("XStoreName");
    *reinterpret_cast<void**>(&L.Sync) = sym("XSync");
    *reinterpret_cast<void**>(&L.Flush) = sym("XFlush");
    *reinterpret_cast<void**>(&L.Pending) = sym("XPending");
    *reinterpret_cast<void**>(&L.NextEvent) = sym("XNextEvent");
    *reinterpret_cast<void**>(&L.PutImage) = sym("XPutImage");
    *reinterpret_cast<void**>(&L.InitImage) = sym("XInitImage");
    *reinterpret_cast<void**>(&L.LookupKeysym) = sym("XLookupKeysym");
    *reinterpret_cast<void**>(&L.InternAtom) = sym("XInternAtom");
    *reinterpret_cast<void**>(&L.SetWMProtocols) = sym("XSetWMProtocols");
    *reinterpret_cast<void**>(&L.DestroyWindow) = sym("XDestroyWindow");
    if (!L.OpenDisplay || !L.CreateSimpleWindow || !L.PutImage ||
        !L.InitImage || !L.NextEvent || !L.LookupKeysym) {
        dlclose(L.handle);
        L.handle = nullptr;
        return nullptr;
    }
    return &L;
}

struct WindowState {
    Display* dpy;
    Window win;
    GC gc;
    Visual* visual;
    int depth;
    int w, h;
    Atom wm_delete;
    uint32_t* buf;  // persistent frame copy XPutImage reads from
};

}  // namespace x11

extern "C" {

// 1 if a window could plausibly open (libX11 loads AND $DISPLAY is set).
int rcw_window_available(void) {
    if (!getenv("DISPLAY")) return 0;
    return x11::lib() != nullptr;
}

// Open a `w` x `h` window; returns an opaque handle or NULL (headless host,
// no libX11, or the display refused the connection).
void* rcw_window_open(const char* title, int w, int h) {
    x11::Lib* L = x11::lib();
    if (!L) return nullptr;
    x11::Display* dpy = L->OpenDisplay(nullptr);
    if (!dpy) return nullptr;
    int screen = L->DefaultScreen(dpy);
    int depth = L->DefaultDepth(dpy, screen);
    if (depth < 24) {  // we only speak 24/32-bit TrueColor
        L->CloseDisplay(dpy);
        return nullptr;
    }
    x11::Window win = L->CreateSimpleWindow(
        dpy, L->RootWindow(dpy, screen), 0, 0,
        static_cast<unsigned>(w), static_cast<unsigned>(h), 0, 0, 0);
    L->SelectInput(dpy, win, x11::KeyPressMask | x11::ExposureMask);
    L->StoreName(dpy, win, title ? title : "raycastworlds_tpu");
    x11::Atom wm_delete = L->InternAtom(dpy, "WM_DELETE_WINDOW", 0);
    if (L->SetWMProtocols) L->SetWMProtocols(dpy, win, &wm_delete, 1);
    L->MapWindow(dpy, win);
    L->Sync(dpy, 0);

    auto* st = new x11::WindowState();
    st->dpy = dpy;
    st->win = win;
    st->gc = L->DefaultGC(dpy, screen);
    st->visual = L->DefaultVisual(dpy, screen);
    st->depth = depth;
    st->w = w;
    st->h = h;
    st->wm_delete = wm_delete;
    st->buf = new uint32_t[static_cast<size_t>(w) * h]();
    return st;
}

// Blit a 0x00RRGGBB frame (row-major h x w, matching the open size).
// Returns 0 on success.
int rcw_window_update(void* handle, const uint32_t* img, int h, int w) {
    if (!handle || !img) return 1;
    auto* st = static_cast<x11::WindowState*>(handle);
    x11::Lib* L = x11::lib();
    if (!L || h != st->h || w != st->w) return 2;
    memcpy(st->buf, img, static_cast<size_t>(h) * w * 4);

    x11::XImage image;
    memset(&image, 0, sizeof image);
    image.width = w;
    image.height = h;
    image.format = x11::ZPixmap;
    image.data = reinterpret_cast<char*>(st->buf);
    image.byte_order = 0;  // LSBFirst: 0x00RRGGBB u32 == BGRX bytes
    image.bitmap_unit = 32;
    image.bitmap_bit_order = 0;
    image.bitmap_pad = 32;
    image.depth = st->depth;
    image.bytes_per_line = w * 4;
    image.bits_per_pixel = 32;
    image.red_mask = 0xFF0000;
    image.green_mask = 0x00FF00;
    image.blue_mask = 0x0000FF;
    if (!L->InitImage(&image)) return 3;
    L->PutImage(st->dpy, st->win, st->gc, &image, 0, 0, 0, 0,
                static_cast<unsigned>(w), static_cast<unsigned>(h));
    L->Flush(st->dpy);
    return 0;
}

// Poll one pending event.  Returns: -1 = nothing pending, -2 = window
// closed by the WM, otherwise the KeySym of a key press (ASCII keys map
// directly: 'w' == 0x77 etc. — the reference key map, single_room.jl:485).
int rcw_window_poll_key(void* handle) {
    if (!handle) return -2;
    auto* st = static_cast<x11::WindowState*>(handle);
    x11::Lib* L = x11::lib();
    if (!L) return -2;
    while (L->Pending(st->dpy) > 0) {
        x11::XEvent ev;
        memset(&ev, 0, sizeof ev);
        L->NextEvent(st->dpy, &ev);
        if (ev.type == x11::KeyPressEvt) {
            x11::KeySym ks = L->LookupKeysym(&ev.xkey, 0);
            if (ks != 0) return static_cast<int>(ks & 0xFFFF);
        } else if (ev.type == x11::ClientMessageEvt &&
                   static_cast<x11::Atom>(ev.xclient.data.l[0]) ==
                       st->wm_delete) {
            return -2;
        }
    }
    return -1;
}

void rcw_window_close(void* handle) {
    if (!handle) return;
    auto* st = static_cast<x11::WindowState*>(handle);
    x11::Lib* L = x11::lib();
    if (L) {
        L->DestroyWindow(st->dpy, st->win);
        L->CloseDisplay(st->dpy);
    }
    delete[] st->buf;
    delete st;
}

}  // extern "C"
