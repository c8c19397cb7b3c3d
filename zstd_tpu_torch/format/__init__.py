"""Host-side format code (copies of the encoder halves of zstd_tpu/format/)."""
