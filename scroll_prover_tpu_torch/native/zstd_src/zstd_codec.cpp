// Pinned-parameter zstd codec for blob encoding.
//
// Role parity with the reference's scroll zstd fork ("hack/mul-block",
// SURVEY.md section 2.2 native component #4): batch payloads are compressed
// with FIXED parameters (level, window log, no dictionary) so the in-circuit
// decompressor sees a deterministic, bounded block format. Built as a shared
// library over the system libzstd; Python binds via ctypes
// (../zstd_codec.py).
#include <zstd.h>

#include <cstddef>
#include <cstdint>

extern "C" {

// Pinned parameters: level 9, window log 22 (blob payloads are < 2^17 bytes,
// so a single frame with one window always results).
static const int kLevel = 9;
static const int kWindowLog = 22;

// Returns compressed size, or 0 on error. dst must hold dst_cap bytes.
size_t spt_zstd_compress(const uint8_t* src, size_t src_len, uint8_t* dst,
                         size_t dst_cap) {
  ZSTD_CCtx* cctx = ZSTD_createCCtx();
  if (!cctx) return 0;
  ZSTD_CCtx_setParameter(cctx, ZSTD_c_compressionLevel, kLevel);
  ZSTD_CCtx_setParameter(cctx, ZSTD_c_windowLog, kWindowLog);
  ZSTD_CCtx_setParameter(cctx, ZSTD_c_contentSizeFlag, 1);
  ZSTD_CCtx_setParameter(cctx, ZSTD_c_checksumFlag, 0);
  size_t n = ZSTD_compress2(cctx, dst, dst_cap, src, src_len);
  ZSTD_freeCCtx(cctx);
  return ZSTD_isError(n) ? 0 : n;
}

// Returns decompressed size, or 0 on error.
size_t spt_zstd_decompress(const uint8_t* src, size_t src_len, uint8_t* dst,
                           size_t dst_cap) {
  size_t n = ZSTD_decompress(dst, dst_cap, src, src_len);
  return ZSTD_isError(n) ? 0 : n;
}

size_t spt_zstd_compress_bound(size_t src_len) {
  return ZSTD_compressBound(src_len);
}

}  // extern "C"
