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
// One change from the JAX package's copy: the output buffers arrive
// zero-filled (the binding allocates them with np.zeros, whose large
// buffers are pages the OS hands over already zero), and only the valid
// rows are written. The JAX copy zeroes its outputs with memset first,
// which touches every page of a 65.5 MB f32 batch and writes the padding
// (~44% of it at ActivityNet-like lengths) a second time.

#include <cstdint>
#include <cstring>

extern "C" {

// Pack ragged frame features.
//   clip_ptrs:    one pointer a clip, clip-major [total_clips]
//   nframes:      frames a clip [total_clips] (true counts, capped here)
//   clip_off:     first clip index of each video [batch+1] (CSR layout)
//   out_frames:   [batch, cmax, fmax, feat], zero-filled by the caller
//   out_framelen: [batch, cmax], zero-filled by the caller
//   out_cliplen:  [batch]
void pack_frames(const float* const* clip_ptrs,
                 const int64_t* nframes,
                 const int64_t* clip_off,
                 int64_t batch, int64_t cmax, int64_t fmax, int64_t feat,
                 float* out_frames,
                 int32_t* out_framelen,
                 int32_t* out_cliplen) {
  const int64_t clip_stride = fmax * feat;
  const int64_t video_stride = cmax * clip_stride;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t c0 = clip_off[b];
    int64_t nclip = clip_off[b + 1] - c0;
    if (nclip > cmax) nclip = cmax;
    out_cliplen[b] = static_cast<int32_t>(nclip);
    for (int64_t c = 0; c < nclip; ++c) {
      int64_t nf = nframes[c0 + c];
      if (nf > fmax) nf = fmax;
      out_framelen[b * cmax + c] = static_cast<int32_t>(nf);
      std::memcpy(out_frames + b * video_stride + c * clip_stride,
                  clip_ptrs[c0 + c], sizeof(float) * nf * feat);
    }
  }
}

// f32 -> bf16, rounding to nearest even (as torch's and ml_dtypes'
// conversions do). A NaN keeps its sign and top payload bits with the quiet
// bit set, as ml_dtypes does; pad_batch writes the same bits.
static inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  std::memcpy(&x, &f, sizeof(x));
  if ((x & 0x7fffffffu) > 0x7f800000u) {  // NaN
    return static_cast<uint16_t>((x >> 16) | 0x0040u);
  }
  const uint32_t rounding_bias = 0x7fffu + ((x >> 16) & 1u);
  return static_cast<uint16_t>((x + rounding_bias) >> 16);
}

// pack_frames for bf16 batches: the conversion runs in the copy loop, so no
// second full-size buffer is made for the cast.
void pack_frames_bf16(const float* const* clip_ptrs,
                      const int64_t* nframes,
                      const int64_t* clip_off,
                      int64_t batch, int64_t cmax, int64_t fmax, int64_t feat,
                      uint16_t* out_frames,
                      int32_t* out_framelen,
                      int32_t* out_cliplen) {
  const int64_t clip_stride = fmax * feat;
  const int64_t video_stride = cmax * clip_stride;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t c0 = clip_off[b];
    int64_t nclip = clip_off[b + 1] - c0;
    if (nclip > cmax) nclip = cmax;
    out_cliplen[b] = static_cast<int32_t>(nclip);
    for (int64_t c = 0; c < nclip; ++c) {
      int64_t nf = nframes[c0 + c];
      if (nf > fmax) nf = fmax;
      out_framelen[b * cmax + c] = static_cast<int32_t>(nf);
      const float* src = clip_ptrs[c0 + c];
      uint16_t* dst = out_frames + b * video_stride + c * clip_stride;
      const int64_t count = nf * feat;
      for (int64_t k = 0; k < count; ++k) dst[k] = f32_to_bf16(src[k]);
    }
  }
}

// Pack ragged token-id sentences (int32), the same CSR layout; out_words
// and out_wordlen zero-filled by the caller.
void pack_tokens(const int32_t* const* sent_ptrs,
                 const int64_t* nwords,
                 const int64_t* sent_off,
                 int64_t batch, int64_t smax, int64_t wmax,
                 int32_t* out_words,
                 int32_t* out_wordlen,
                 int32_t* out_sentlen) {
  const int64_t sent_stride = wmax;
  const int64_t para_stride = smax * wmax;
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t s0 = sent_off[b];
    int64_t nsent = sent_off[b + 1] - s0;
    if (nsent > smax) nsent = smax;
    out_sentlen[b] = static_cast<int32_t>(nsent);
    for (int64_t s = 0; s < nsent; ++s) {
      int64_t nw = nwords[s0 + s];
      if (nw > wmax) nw = wmax;
      out_wordlen[b * smax + s] = static_cast<int32_t>(nw);
      std::memcpy(out_words + b * para_stride + s * sent_stride,
                  sent_ptrs[s0 + s], sizeof(int32_t) * nw);
    }
  }
}

}  // extern "C"
