"""Dictionary training (`zstd --train` analog).

Copy of zstd_tpu/dict_builder/: fastCover-style d-mer frequency training
(zstd's lib/dictBuilder/fastcover.c) with numpy-vectorized counting, the
COVER trainer with exact d-mer counts and its k/d sweep (cover.c), and the
dictionary finalizer (zdict.c). Host code: it imports no torch.
"""
