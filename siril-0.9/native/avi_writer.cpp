// Native AVI (DIB) writer — this framework's equivalent of the
// reference's PIPP-derived C++ writer (src/io/avi_pipp/pipp_avi_write.cpp
// + pipp_avi_write_dib.cpp): uncompressed bottom-up DIB frames in a RIFF
// AVI container with an idx1 index, used by sequence export.
//
// C ABI for ctypes:
//   void*  avi_create(const char* path, int w, int h, double fps, int color);
//   int    avi_write_frame(void* handle, const unsigned char* data, long n);
//   int    avi_close(void* handle);
//
// Frames are BGR24 (color=1) or replicated-gray BGR24 (the Python layer
// converts mono to BGR) with rows bottom-up, 4-byte-aligned — the DIB
// convention.
//
// Build: g++ -O2 -shared -fPIC avi_writer.cpp -o libsirilnative.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct AviWriter {
    FILE *f = nullptr;
    int width = 0;
    int height = 0;
    double fps = 25.0;
    int row_bytes = 0;      // aligned
    int frame_bytes = 0;
    long nframes = 0;
    long movi_start = 0;
    std::vector<uint32_t> index_offsets;

    // header patch positions
    long pos_riff_size = 0;
    long pos_total_frames = 0;
    long pos_length = 0;
    long pos_movi_size = 0;
};

void w32(FILE *f, uint32_t v) { fwrite(&v, 4, 1, f); }
void w16(FILE *f, uint16_t v) { fwrite(&v, 2, 1, f); }
void wtag(FILE *f, const char *t) { fwrite(t, 4, 1, f); }

} // namespace

extern "C" {

void *avi_create(const char *path, int w, int h, double fps, int /*color*/) {
    AviWriter *a = new AviWriter();
    a->f = fopen(path, "wb");
    if (!a->f) { delete a; return nullptr; }
    a->width = w;
    a->height = h;
    a->fps = fps > 0 ? fps : 25.0;
    a->row_bytes = (w * 3 + 3) & ~3;
    a->frame_bytes = a->row_bytes * h;

    FILE *f = a->f;
    // RIFF header
    wtag(f, "RIFF");
    a->pos_riff_size = ftell(f); w32(f, 0);
    wtag(f, "AVI ");

    // hdrl list
    wtag(f, "LIST");
    w32(f, 4 + 8 + 56 + 8 + 4 + 8 + 56 + 8 + 40);  // hdrl size
    wtag(f, "hdrl");

    // avih (main header), 56 bytes payload
    wtag(f, "avih"); w32(f, 56);
    uint32_t usec_per_frame = (uint32_t)(1000000.0 / a->fps);
    w32(f, usec_per_frame);
    w32(f, (uint32_t)(a->frame_bytes * a->fps));   // max bytes/sec
    w32(f, 0);                                     // padding granularity
    w32(f, 0x10);                                  // flags: HASINDEX
    a->pos_total_frames = ftell(f); w32(f, 0);     // total frames (patched)
    w32(f, 0);                                     // initial frames
    w32(f, 1);                                     // streams
    w32(f, a->frame_bytes);                        // suggested buffer
    w32(f, w); w32(f, h);
    w32(f, 0); w32(f, 0); w32(f, 0); w32(f, 0);    // reserved

    // strl list
    wtag(f, "LIST");
    w32(f, 4 + 8 + 56 + 8 + 40);
    wtag(f, "strl");

    // strh, 56 bytes
    wtag(f, "strh"); w32(f, 56);
    wtag(f, "vids"); wtag(f, "DIB ");
    w32(f, 0); w16(f, 0); w16(f, 0);               // flags, prio, lang
    w32(f, 0);                                     // initial frames
    w32(f, 1000);                                  // scale
    w32(f, (uint32_t)(a->fps * 1000.0));           // rate
    w32(f, 0);                                     // start
    a->pos_length = ftell(f); w32(f, 0);           // length (patched)
    w32(f, a->frame_bytes);                        // suggested buffer
    w32(f, 0xFFFFFFFFu);                           // quality
    w32(f, 0);                                     // sample size
    w16(f, 0); w16(f, 0); w16(f, (uint16_t)w); w16(f, (uint16_t)h);

    // strf: BITMAPINFOHEADER, 40 bytes
    wtag(f, "strf"); w32(f, 40);
    w32(f, 40);
    w32(f, (uint32_t)w);
    w32(f, (uint32_t)h);                           // positive: bottom-up
    w16(f, 1); w16(f, 24);                         // planes, bpp
    w32(f, 0);                                     // BI_RGB
    w32(f, (uint32_t)a->frame_bytes);
    w32(f, 2835); w32(f, 2835);
    w32(f, 0); w32(f, 0);

    // movi list
    wtag(f, "LIST");
    a->pos_movi_size = ftell(f); w32(f, 0);
    wtag(f, "movi");
    a->movi_start = ftell(f);
    return a;
}

int avi_write_frame(void *handle, const unsigned char *data, long n) {
    AviWriter *a = (AviWriter *)handle;
    if (!a || !a->f) return -1;
    if (n != a->frame_bytes) return -2;
    long off = ftell(a->f);
    wtag(a->f, "00db");
    w32(a->f, (uint32_t)a->frame_bytes);
    if (fwrite(data, 1, (size_t)n, a->f) != (size_t)n) return -3;
    if (a->frame_bytes & 1) fputc(0, a->f);
    a->index_offsets.push_back((uint32_t)(off - a->movi_start + 4));
    a->nframes++;
    return 0;
}

int avi_close(void *handle) {
    AviWriter *a = (AviWriter *)handle;
    if (!a) return -1;
    FILE *f = a->f;
    if (f) {
        long movi_end = ftell(f);
        // idx1 index
        wtag(f, "idx1");
        w32(f, (uint32_t)(a->nframes * 16));
        for (long i = 0; i < a->nframes; i++) {
            wtag(f, "00db");
            w32(f, 0x10);  // AVIIF_KEYFRAME
            w32(f, a->index_offsets[(size_t)i]);
            w32(f, (uint32_t)a->frame_bytes);
        }
        long file_end = ftell(f);

        fseek(f, a->pos_riff_size, SEEK_SET);
        w32(f, (uint32_t)(file_end - 8));
        fseek(f, a->pos_total_frames, SEEK_SET);
        w32(f, (uint32_t)a->nframes);
        fseek(f, a->pos_length, SEEK_SET);
        w32(f, (uint32_t)a->nframes);
        fseek(f, a->pos_movi_size, SEEK_SET);
        w32(f, (uint32_t)(movi_end - a->pos_movi_size - 4));
        fclose(f);
    }
    delete a;
    return 0;
}

} // extern "C"
