// Native batch packer of cmhse_tpu_torch: ragged clip/sentence arrays ->
// fixed-shape padded batch buffers, the per-batch host work of
// data/bucketing.py::pad_batch. The port's own copy of the JAX package's
// packer (cmhse_tpu/native/packer.cpp), with the same C signatures; the numpy
// pad_batch stays as its plain version (tests/test_torch_native.py).
//
// Host code only (no CUDA). Built at first use by native/__init__.py:
//   g++ -O3 -shared -fPIC packer.cpp -o libpacker.so
// and driven through ctypes.
//
// Two kinds of entry point, for two kinds of output memory; they share the
// row copy and nothing of how the padding is made:
//
//  * pack_frames, pack_frames_bf16, pack_tokens write the live rows only,
//    into outputs that arrive zero-filled. The pageable path
//    (pack_batch_native without pinned, and so serve.py and every CPU-only
//    process) allocates them with np.zeros, whose large buffers are pages
//    the OS hands over already zero: writing the padding there would fault
//    in every page of a 65.5 MB f32 batch for nothing. The JAX copy zeroes
//    its outputs with memset first, the same cost.
//  * pack_frames_padded, pack_frames_padded_bf16, pack_tokens_padded write
//    every byte of every output once: live rows copied, each contiguous run
//    of padding (a clip's tail, empty clips, the rows of a short batch)
//    zeroed by one memset, every length written. They are for reused
//    memory: the page-locked blocks of PyTorch's caching host allocator that
//    pack_batch_native(pinned=True) packs into (the loader on a CUDA
//    process), whose old contents must not leak into the batch.

#include <cstdint>
#include <cstring>

namespace {

// f32 -> bf16, rounding to nearest even (as torch's and ml_dtypes'
// conversions do). A NaN keeps its sign and top payload bits with the quiet
// bit set, as ml_dtypes does; pad_batch writes the same bits.
inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, sizeof(x));
  if ((x & 0x7fffffffu) > 0x7f800000u) {  // NaN
    return static_cast<uint16_t>((x >> 16) | 0x0040u);
  }
  const uint32_t rounding_bias = 0x7fffu + ((x >> 16) & 1u);
  return static_cast<uint16_t>((x + rounding_bias) >> 16);
}

// One clip's live rows; bf16 is rounded in the copy loop, so no second
// full-size buffer is made for the cast.
inline void copy_rows(float* dst, const float* src, int64_t count) {
  std::memcpy(dst, src, sizeof(float) * count);
}
inline void copy_rows(uint16_t* dst, const float* src, int64_t count) {
  for (int64_t k = 0; k < count; ++k) dst[k] = f32_to_bf16(src[k]);
}
inline void copy_rows(int32_t* dst, const int32_t* src, int64_t count) {
  std::memcpy(dst, src, sizeof(int32_t) * count);
}

// Live rows only, into zero-filled outputs (see the header).
template <typename Src, typename Dst>
void pack_live(const Src* const* row_ptrs, const int64_t* nrows,
               const int64_t* row_off, int64_t batch, int64_t smax,
               int64_t rmax, int64_t width, Dst* out, int32_t* out_rowlen,
               int32_t* out_len) {
  const int64_t slot_stride = rmax * width;
  const int64_t item_stride = smax * slot_stride;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t s0 = row_off[b];
    int64_t n = row_off[b + 1] - s0;
    if (n > smax) n = smax;
    out_len[b] = static_cast<int32_t>(n);
    for (int64_t s = 0; s < n; ++s) {
      int64_t nr = nrows[s0 + s];
      if (nr > rmax) nr = rmax;
      out_rowlen[b * smax + s] = static_cast<int32_t>(nr);
      copy_rows(out + b * item_stride + s * slot_stride, row_ptrs[s0 + s],
                nr * width);
    }
  }
}

// Every byte of every output, once (see the header): `pad` is where the
// padding not yet written starts, and each live copy first zeroes the run
// from there to itself.
template <typename Src, typename Dst>
void pack_padded(const Src* const* row_ptrs, const int64_t* nrows,
                 const int64_t* row_off, int64_t batch, int64_t smax,
                 int64_t rmax, int64_t width, Dst* out, int32_t* out_rowlen,
                 int32_t* out_len) {
  const int64_t slot_stride = rmax * width;
  const int64_t item_stride = smax * slot_stride;
  Dst* pad = out;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t s0 = row_off[b];
    int64_t n = row_off[b + 1] - s0;
    if (n > smax) n = smax;
    out_len[b] = static_cast<int32_t>(n);
    for (int64_t s = 0; s < smax; ++s) {
      int64_t nr = s < n ? nrows[s0 + s] : 0;
      if (nr > rmax) nr = rmax;
      out_rowlen[b * smax + s] = static_cast<int32_t>(nr);
      if (nr == 0) continue;
      Dst* dst = out + b * item_stride + s * slot_stride;
      std::memset(pad, 0, sizeof(Dst) * (dst - pad));
      copy_rows(dst, row_ptrs[s0 + s], nr * width);
      pad = dst + nr * width;
    }
  }
  std::memset(pad, 0, sizeof(Dst) * (out + batch * item_stride - pad));
}

}  // namespace

extern "C" {

// Pack ragged frame features.
//   clip_ptrs:    one pointer a clip, clip-major [total_clips]
//   nframes:      frames a clip [total_clips] (true counts, capped here)
//   clip_off:     first clip index of each video [batch+1] (CSR layout)
//   out_frames:   [batch, cmax, fmax, feat], zero-filled by the caller
//   out_framelen: [batch, cmax], zero-filled by the caller
//   out_cliplen:  [batch]
void pack_frames(const float* const* clip_ptrs, const int64_t* nframes,
                 const int64_t* clip_off, int64_t batch, int64_t cmax,
                 int64_t fmax, int64_t feat, float* out_frames,
                 int32_t* out_framelen, int32_t* out_cliplen) {
  pack_live(clip_ptrs, nframes, clip_off, batch, cmax, fmax, feat, out_frames,
            out_framelen, out_cliplen);
}

// pack_frames for bf16 batches (bf16 bits in out_frames).
void pack_frames_bf16(const float* const* clip_ptrs, const int64_t* nframes,
                      const int64_t* clip_off, int64_t batch, int64_t cmax,
                      int64_t fmax, int64_t feat, uint16_t* out_frames,
                      int32_t* out_framelen, int32_t* out_cliplen) {
  pack_live(clip_ptrs, nframes, clip_off, batch, cmax, fmax, feat, out_frames,
            out_framelen, out_cliplen);
}

// Pack ragged token-id sentences (int32), the same CSR layout; out_words
// and out_wordlen zero-filled by the caller.
void pack_tokens(const int32_t* const* sent_ptrs, const int64_t* nwords,
                 const int64_t* sent_off, int64_t batch, int64_t smax,
                 int64_t wmax, int32_t* out_words, int32_t* out_wordlen,
                 int32_t* out_sentlen) {
  pack_live(sent_ptrs, nwords, sent_off, batch, smax, wmax, int64_t{1},
            out_words, out_wordlen, out_sentlen);
}

// The same three with the same arguments, for outputs of any contents:
// every byte written.
void pack_frames_padded(const float* const* clip_ptrs, const int64_t* nframes,
                        const int64_t* clip_off, int64_t batch, int64_t cmax,
                        int64_t fmax, int64_t feat, float* out_frames,
                        int32_t* out_framelen, int32_t* out_cliplen) {
  pack_padded(clip_ptrs, nframes, clip_off, batch, cmax, fmax, feat,
              out_frames, out_framelen, out_cliplen);
}

void pack_frames_padded_bf16(const float* const* clip_ptrs,
                             const int64_t* nframes, const int64_t* clip_off,
                             int64_t batch, int64_t cmax, int64_t fmax,
                             int64_t feat, uint16_t* out_frames,
                             int32_t* out_framelen, int32_t* out_cliplen) {
  pack_padded(clip_ptrs, nframes, clip_off, batch, cmax, fmax, feat,
              out_frames, out_framelen, out_cliplen);
}

void pack_tokens_padded(const int32_t* const* sent_ptrs,
                        const int64_t* nwords, const int64_t* sent_off,
                        int64_t batch, int64_t smax, int64_t wmax,
                        int32_t* out_words, int32_t* out_wordlen,
                        int32_t* out_sentlen) {
  pack_padded(sent_ptrs, nwords, sent_off, batch, smax, wmax, int64_t{1},
              out_words, out_wordlen, out_sentlen);
}

}  // extern "C"
