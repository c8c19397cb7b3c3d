"""zstd_tpu_torch's host features on the CPU, against zstd_tpu's: the
streaming XXH64, frames with a window prefix (--patch-from) and with a
target block size (the superblock pieces), the frame helpers, rsyncable
chunking, lz4 frames, the streaming codec, the async file I/O, dictionaries,
the trace CSV and the top-level API. Every comparison is exact: the same
bytes, digests, levels and error types.

One fault of zstd_tpu is not inherited and is pinned here: its superblock
pieces leave their region's Huffman table marked VALID for the next region,
whose literals it may not cover, so a later block goes treeless against a
table without its symbols and the frame does not decode. In the cases of
TARGET_FAULTS zstd_tpu's frame fails to decode and the port's, which checks
a VALID table before it reuses it, decodes; every other frame is equal
(test_target_block_size_equals_jax).
"""

import dataclasses

import numpy as np
import pytest

import zstd_tpu
import zstd_tpu_torch
from tests.bigcorpus import big_corpus
from tests.conftest import gen_text
from tests.refnative import reference_native
from zstd_tpu import dictionary as jdict
from zstd_tpu import fileio_async as jfio
from zstd_tpu import lz4frame as jlz4
from zstd_tpu import rsync as jrsync
from zstd_tpu import streaming as jstream
from zstd_tpu import trace as jtrace
from zstd_tpu import xxhash64 as jxxh
from zstd_tpu.dict_builder.fastcover import train_from_samples
from zstd_tpu.dict_builder.zdict import finalize_dictionary
from zstd_tpu.format import codec as jcodec
from zstd_tpu.format import frame as jframe
from zstd_tpu.format import fse as jfse
from zstd_tpu.format import huffman as jhuf
from zstd_tpu.parallel import pzstd as jpz
from zstd_tpu_torch import dictionary as tdict
from zstd_tpu_torch import fileio_async as tfio
from zstd_tpu_torch import lz4frame as tlz4
from zstd_tpu_torch import rsync as trsync
from zstd_tpu_torch import streaming as tstream
from zstd_tpu_torch import trace as ttrace
from zstd_tpu_torch import xxhash64 as txxh
from zstd_tpu_torch.format import codec as tcodec
from zstd_tpu_torch.format import frame as tframe
from zstd_tpu_torch.parallel import pzstd as tpz

BIG = big_corpus(256 * 1024)
TEXT = gen_text(96 * 1024, seed=7)
RAND = np.random.default_rng(11).integers(0, 256, 40_000,
                                          dtype=np.uint8).tobytes()


def _mutated(data: bytes, n: int = 8, seed: int = 3) -> bytes:
    out = bytearray(data)
    rng = np.random.default_rng(seed)
    for at in rng.integers(0, len(out), n):
        out[int(at)] ^= 0x5A
    return bytes(out)


@pytest.fixture(scope="module", autouse=True)
def _native():
    """zstd_tpu's frames are those of its C parsers."""
    assert reference_native() is not None, \
        "zstd_tpu's C library is not built"


def _err_type(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:          # the type and code, not the message
        return type(e).__name__, getattr(getattr(e, "code", None), "name",
                                         None)
    return None


# ---- XXH64 -----------------------------------------------------------------

@pytest.mark.parametrize("chunk", (1, 7, 32, 4093))
@pytest.mark.parametrize("size", (0, 31, 32, 1000, 70_001))
@pytest.mark.parametrize("plain", (False, True))
def test_xxh64_stream_equals_jax(plain, size, chunk):
    data = RAND[:size] if size <= len(RAND) else (RAND * 2)[:size]
    if plain and size > 1000 and chunk < 32:
        chunk *= 64                      # the Python state is slow per call
    want, got = jxxh.Xxh64(seed=9), txxh.Xxh64(seed=9, plain=plain)
    for i in range(0, len(data), chunk):
        want.update(data[i : i + chunk])
        got.update(memoryview(data)[i : i + chunk])
    assert got.digest() == want.digest() == jxxh.xxh64(data, 9)
    got.reset()
    got.update(data)
    assert got.digest() == want.digest()
    assert txxh.xxh64(data, 9) == jxxh.xxh64(data, 9)


# ---- frames with a window prefix and a target block size --------------------

@pytest.mark.parametrize("level", (1, 3, 9, 19))
@pytest.mark.parametrize("name", ("big", "text"))
def test_patch_frames_equal_jax(name, level):
    new = BIG if name == "big" else TEXT
    old = _mutated(new)
    if level == 19:
        new, old = new[:96 * 1024], old[:96 * 1024]
    want = jcodec.compress_patch(new, old, level=level, checksum=True)
    got = tcodec.compress_patch(new, old, level=level, checksum=True)
    assert got == want and len(got) < len(new) // 8
    assert tcodec.decompress_patch(got, old) == new
    assert jcodec.decompress_patch(got, old) == new
    # the C decoder and the Python branch, with the prefix
    hdr = tframe.parse_frame_header(got, 31)
    assert tframe.decompress_frame_prefix(got, 0, old) == (new, len(got))
    assert tframe.decompress_frame_plain(got, 0, 31, prefix=old) == \
        (new, len(got))
    assert not hdr.single_segment


def test_patch_with_the_wrong_prefix_fails_alike():
    new = BIG[:64 * 1024]
    old = _mutated(new)
    blob = tcodec.compress_patch(new, old, level=3, checksum=True)
    other = _mutated(new, seed=4)
    assert _err_type(tcodec.decompress_patch, blob, other) == \
        _err_type(jcodec.decompress_patch, blob, other) is not None


# (input, level, target) where zstd_tpu's frame does not decode
TARGET_FAULTS = {("big", 3, 1024), ("big", 9, 1024), ("big", 9, 2048),
                 ("big", 19, 1024), ("big", 19, 2048)}


@pytest.mark.parametrize("target", (1024, 2048, 8192))
@pytest.mark.parametrize("level", (1, 3, 9, 19))
@pytest.mark.parametrize("name", ("big", "text"))
def test_target_block_size_equals_jax(name, level, target):
    data = BIG if name == "big" else TEXT
    if level == 19:
        data = data[:128 * 1024]
    want = jcodec.compress(data, level=level, checksum=True,
                           target_cblock_size=target)
    got = tcodec.compress(data, level=level, checksum=True,
                          target_cblock_size=target)
    if (name, level, target) in TARGET_FAULTS:
        with pytest.raises(zstd_tpu.ZstdError, match="huffman"):
            jcodec.decompress(want)
        assert got != want
        assert jcodec.decompress(got) == data
        assert abs(len(got) - len(want)) < len(want) // 10
    else:
        assert got == want
    assert tcodec.decompress(got) == data
    blocks = _block_sizes(got)
    assert len(blocks) > len(data) // (128 * 1024)


def _block_sizes(frame: bytes) -> list[int]:
    hdr = tframe.parse_frame_header(frame, 31)
    p, sizes, last = hdr.header_size, [], False
    while not last:
        bh = int.from_bytes(frame[p : p + 3], "little")
        last, btype, bsize = bool(bh & 1), (bh >> 1) & 3, bh >> 3
        sizes.append(bsize)
        p += 3 + (1 if btype == 1 else bsize)
    return sizes


# ---- the frame helpers ------------------------------------------------------

FRAMES = {"one": jcodec.compress(BIG[:50_000], level=3, checksum=True),
          "nofcs": jstream.CompressStream(level=1).write(TEXT[:5000])
          + b"",
          "skip": jframe.write_skippable_frame(b"hello", 3),
          "dictid": jdict.compress_with_dict(
              TEXT[:3000], jdict.load_dictionary(
                  finalize_dictionary(TEXT[:8000], [TEXT[8000:20000]],
                                      dict_id=0x1234567)), level=3)}
FRAMES["nofcs"] = (lambda s: s.write(TEXT[:5000]) + s.finish())(
    jstream.CompressStream(level=1, checksum=True))
HELPERS = ("is_frame", "get_frame_content_size", "find_frame_compressed_size",
           "get_dict_id_from_frame")


@pytest.mark.parametrize("helper", HELPERS)
@pytest.mark.parametrize("name", sorted(FRAMES) + ["garbage", "short"])
def test_frame_helpers_equal_jax(name, helper):
    data = FRAMES.get(name, b"\x00\x01\x02\x03\x04\x05\x06\x07" if
                      name == "garbage" else b"\x28\xb5")
    data = data + b"tail"
    want = _call(getattr(jframe, helper), data)
    assert _call(getattr(tframe, helper), data) == want
    assert _call(getattr(zstd_tpu_torch, helper), data) == want


def _call(fn, *args):
    try:
        return ("ok", fn(*args))
    except Exception as e:
        return ("raise", type(e).__name__)


@pytest.mark.parametrize("size", (0, 1, 2047, 131_072, 131_073, 10 ** 7))
def test_compress_bound_and_skippable_equal_jax(size):
    assert tframe.compress_bound(size) == jframe.compress_bound(size)
    assert zstd_tpu_torch.compress_bound(size) == zstd_tpu.compress_bound(size)
    user = RAND[: size % 997]
    for variant in (0, 15):
        assert tframe.write_skippable_frame(user, variant) == \
            jframe.write_skippable_frame(user, variant)
    assert _err_type(tframe.write_skippable_frame, user, 16) == \
        _err_type(jframe.write_skippable_frame, user, 16)


def test_dict_id_from_dict_equals_jax():
    d = finalize_dictionary(TEXT[:8000], [TEXT[8000:20000]], dict_id=777)
    for blob in (d, TEXT[:100], b"abc"):
        assert tframe.get_dict_id_from_dict(blob) == \
            jframe.get_dict_id_from_dict(blob)
    assert zstd_tpu_torch.get_dict_id_from_dict(d) == 777


# ---- rsyncable chunking ------------------------------------------------------

@pytest.mark.parametrize("avg_log", (15, 17, 19))
@pytest.mark.parametrize("name", ("big", "mutated", "zeros"))
def test_sync_points_equal_jax(name, avg_log):
    data = {"big": BIG * 3, "mutated": _mutated(BIG * 3, 20),
            "zeros": bytes(700_000)}[name]
    want = jrsync.sync_points(data, avg_log=avg_log)
    assert trsync.sync_points(data, avg_log=avg_log) == want
    assert trsync.split_rsyncable(data, avg_log=avg_log) == \
        jrsync.split_rsyncable(data, avg_log=avg_log)


@pytest.mark.parametrize("level", (1, 3))
def test_pzstd_rsync_equals_jax(level):
    data = BIG * 3
    want = jpz.pzstd_compress(data, level=level, checksum=True, workers=2,
                              executor="thread", rsync_log=17)
    got = tpz.pzstd_compress(data, level=level, checksum=True, workers=2,
                             executor="thread", rsync_log=17)
    assert got == want
    assert tpz.pzstd_decompress(got) == data
    # a local edit re-synchronizes: most frames stay the same
    edited = tpz.pzstd_compress(_mutated(data, 1), level=level,
                                checksum=True, workers=2, executor="thread",
                                rsync_log=17)
    assert len(set(_frames(edited)) & set(_frames(got))) >= \
        len(_frames(got)) - 2


def _frames(stream: bytes) -> list[bytes]:
    out, pos = [], 0
    while pos < len(stream):
        n = tframe.find_frame_compressed_size(stream, pos)
        out.append(stream[pos : pos + n])
        pos += n
    return out


# ---- lz4 frames ---------------------------------------------------------------

@pytest.mark.parametrize("checksum", (True, False))
@pytest.mark.parametrize("code", (4, 5, 6, 7))
@pytest.mark.parametrize("name", ("big", "rand", "empty"))
def test_lz4_frames_equal_jax(name, code, checksum):
    data = {"big": BIG, "rand": RAND, "empty": b""}[name]
    want = jlz4.compress_lz4(data, block_max_code=code,
                             content_checksum=checksum)
    got = tlz4.compress_lz4(data, block_max_code=code,
                            content_checksum=checksum)
    assert got == want
    assert tlz4.decompress_lz4(want) == jlz4.decompress_lz4(want) == \
        (data, len(want))
    assert tlz4.is_lz4_frame(got) == jlz4.is_lz4_frame(got)


@pytest.mark.parametrize("cut", ("header", "hc", "block", "content_sum",
                                 "truncated", "version"))
def test_lz4_corrupt_frames_fail_alike(cut):
    blob = bytearray(jlz4.compress_lz4(BIG[:70_000]))
    if cut == "header":
        blob = blob[:6]
    elif cut == "hc":
        blob[14] ^= 1
    elif cut == "block":
        blob[40] ^= 0xFF
    elif cut == "content_sum":
        blob[-1] ^= 1
    elif cut == "truncated":
        blob = blob[:-9]
    else:
        blob[4] ^= 0x80
    blob = bytes(blob)
    assert _err_type(tlz4.decompress_lz4, blob) == \
        _err_type(jlz4.decompress_lz4, blob) is not None


# ---- the streaming codec ------------------------------------------------------

CHUNKINGS = {"one": [10 ** 9], "uneven": [1, 7, 4096, 100_000, 3, 131_072],
             "bytewise_head": [1] * 40 + [65_536]}


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
@pytest.mark.parametrize("level", (1, 3, 9))
def test_compress_stream_equals_jax(level, chunking):
    data = BIG
    pieces, pos, sizes = [], 0, CHUNKINGS[chunking]
    while pos < len(data):
        n = sizes[len(pieces) % len(sizes)]
        pieces.append(data[pos : pos + n])
        pos += n
    outs = []
    for mod in (jstream, tstream):
        cs = mod.CompressStream(level=level, checksum=True)
        got = [cs.write(p) for p in pieces[:3]]
        got.append(cs.flush())
        got += [cs.write(p) for p in pieces[3:]]
        got.append(cs.finish())
        got.append(cs.finish())
        outs.append(got)
    assert outs[1] == outs[0]
    frame = b"".join(outs[1])
    assert tcodec.decompress(frame) == data


@pytest.mark.parametrize("chunking", sorted(CHUNKINGS))
def test_decompress_stream_equals_jax(chunking):
    data = BIG
    frames = (jcodec.compress(data[:100_000], level=3, checksum=True)
              + jframe.write_skippable_frame(b"meta")
              + (lambda s: s.write(data[100_000:]) + s.finish())(
                  jstream.CompressStream(level=1, checksum=True)))
    sizes = CHUNKINGS[chunking]
    outs = []
    for mod in (jstream, tstream):
        ds = mod.DecompressStream()
        got, pos, k = [], 0, 0
        while pos < len(frames):
            n = sizes[k % len(sizes)]
            got.append(ds.write(frames[pos : pos + n]))
            pos, k = pos + n, k + 1
        got.append(ds.finish())
        outs.append(got)
    assert outs[1] == outs[0]
    assert b"".join(outs[1]) == data


@pytest.mark.parametrize("fault", ("checksum", "truncated", "write_after"))
def test_stream_errors_equal_jax(fault):
    frame = jcodec.compress(TEXT[:20_000], level=3, checksum=True)
    res = []
    for mod in (jstream, tstream):
        if fault == "write_after":
            cs = mod.CompressStream(level=3)
            cs.finish()
            res.append(_err_type(cs.write, b"x"))
            continue
        ds = mod.DecompressStream()
        blob = frame[:-1] + bytes([frame[-1] ^ 1]) if fault == "checksum" \
            else frame[:-10]

        def run(ds=ds, blob=blob):
            ds.write(blob)
            ds.finish()
        res.append(_err_type(run))
    assert res[0] == res[1] is not None


# ---- the async file I/O -------------------------------------------------------

def test_file_async_equals_jax(tmp_path):
    src = tmp_path / "in.bin"
    src.write_bytes(BIG * 4 + bytes(200_000) + TEXT)
    for mod, tag in ((jfio, "j"), (tfio, "t")):
        mod.compress_file_async(str(src), str(tmp_path / f"{tag}.zst"),
                                level=3)
        mod.decompress_file_async(str(tmp_path / f"{tag}.zst"),
                                  str(tmp_path / f"{tag}.out"))
    assert (tmp_path / "t.zst").read_bytes() == \
        (tmp_path / "j.zst").read_bytes()
    assert (tmp_path / "t.out").read_bytes() == src.read_bytes()


def test_file_adaptive_equals_jax(tmp_path, monkeypatch):
    """The level walk depends on queue fill; with one decision rule
    patched into both (up, up, down, ...) the frames are equal."""
    src = tmp_path / "in.bin"
    src.write_bytes(BIG * 5)
    levels = []
    for mod, tag in ((jfio, "j"), (tfio, "t")):
        it = iter([1, 1, -1, 1, -1, -1] * 10)
        monkeypatch.setattr(mod, "_adapt_decide",
                            lambda s, w, b, level, lo, hi, it=it:
                            min(max(level + next(it), lo), hi))
        levels.append(mod.compress_file_adaptive(
            str(src), str(tmp_path / f"{tag}.zst"), level=2, lo=1, hi=4,
            chunk_size=256 * 1024))
    assert levels[0] == levels[1] and len(set(levels[0])) > 1
    assert (tmp_path / "t.zst").read_bytes() == \
        (tmp_path / "j.zst").read_bytes()
    assert tcodec.decompress((tmp_path / "t.zst").read_bytes()) == \
        src.read_bytes()
    for starved, waiting, backed in ((1, 0, 0), (0, 1, 0), (0, 1, 1),
                                     (0, 0, 0)):
        for level in (1, 3, 19):
            assert tfio._adapt_decide(starved, waiting, backed, level, 1,
                                      19) == \
                jfio._adapt_decide(starved, waiting, backed, level, 1, 19)


# ---- dictionaries ---------------------------------------------------------------

def _samples():
    return [gen_text(1500 + 97 * i, seed=100 + i) for i in range(40)]


DICT = finalize_dictionary(train_from_samples(_samples(), max_dict_size=8192),
                           _samples(), dict_id=4242)


@pytest.mark.parametrize("level", (1, 3, 9, 19))
@pytest.mark.parametrize("kind", ("trained", "raw"))
def test_dictionary_frames_equal_jax(kind, level):
    blob = DICT if kind == "trained" else TEXT[:6000]
    jd, td = jdict.load_dictionary(blob), tdict.load_dictionary(blob)
    assert (td.dict_id, td.content, td.reps) == (jd.dict_id, jd.content,
                                                 jd.reps)
    assert (td.huf_full, td.of_cov_max, td.ml_full, td.ll_full) == \
        (jd.huf_full, jd.of_cov_max, jd.ml_full, jd.ll_full)
    for data in (gen_text(3000, seed=900), gen_text(40_000, seed=901), b""):
        want = jdict.compress_with_dict(data, jd, level=level, checksum=True)
        got = tdict.compress_with_dict(data, td, level=level, checksum=True)
        assert got == want
        assert tdict.decompress_with_dict(got, td) == data
        assert jdict.decompress_with_dict(got, jd) == data


def test_write_dictionary_equals_jax():
    jd = jdict.load_dictionary(DICT)
    td = tdict.load_dictionary(DICT)
    # the port's table rebuilt from code lengths equals zstd_tpu's
    assert np.array_equal(td.huf_ctable.value, jd.huf_ctable.value)
    content = DICT[-2000:]
    norm_of, _, log_of, c1 = jfse.read_ncount(DICT[8 + _tree_len(DICT):],
                                              31, 8)
    rest = DICT[8 + _tree_len(DICT) + c1:]
    norm_ml, _, log_ml, c2 = jfse.read_ncount(rest, 52, 9)
    norm_ll, _, log_ll, _ = jfse.read_ncount(rest[c2:], 35, 9)
    args = (99, content, norm_of, log_of, norm_ml, log_ml, norm_ll, log_ll,
            (1, 4, 8))
    want = jdict.write_dictionary(args[0], args[1], jd.huf_ctable, *args[2:])
    got = tdict.write_dictionary(args[0], args[1], td.huf_ctable, *args[2:])
    assert got == want
    assert tdict.load_dictionary(got).dict_id == 99


def _tree_len(d: bytes) -> int:
    return jhuf.read_tree_description(d[8:])[3]


@pytest.mark.parametrize("fault", ("short", "wrong_id", "bad_rep"))
def test_dictionary_errors_equal_jax(fault):
    if fault == "short":
        args = ("load", b"\x37\xa4\x30")
    elif fault == "bad_rep":
        bad = bytearray(DICT)
        cut = len(DICT) - len(jdict.load_dictionary(DICT).content)
        bad[cut - 12 : cut - 8] = (10 ** 8).to_bytes(4, "little")
        args = ("load", bytes(bad))
    else:
        frame = jdict.compress_with_dict(TEXT[:500], jdict.load_dictionary(
            DICT), level=3)
        other = finalize_dictionary(TEXT[:8000], [TEXT[8000:20000]],
                                    dict_id=5)
        args = ("decode", frame, other)
    res = []
    for mod in (jdict, tdict):
        if args[0] == "load":
            res.append(_err_type(mod.load_dictionary, args[1]))
        else:
            res.append(_err_type(mod.decompress_with_dict, args[1],
                                 mod.load_dictionary(args[2])))
    assert res[0] == res[1] is not None


# ---- the trace CSV and the top-level API ----------------------------------------

def test_trace_rows_equal_jax(tmp_path):
    """The CSV rows of a compress and a decompress, without the time
    columns (Duration Nanos, Speed MB/s)."""
    rows = []
    for mod, codec, tag in ((jtrace, jcodec, "j"), (ttrace, tcodec, "t")):
        path = tmp_path / f"{tag}.csv"
        mod.GLOBAL_TRACER.open_csv(str(path))
        try:
            blob = codec.compress(TEXT, level=5, checksum=True)
            codec.decompress(blob)
        finally:
            mod.GLOBAL_TRACER._csv.close()
            mod.GLOBAL_TRACER._csv = None
        lines = path.read_text().splitlines()
        rows.append([",".join(c for i, c in enumerate(ln.split(","))
                              if i not in (9, 10)) for ln in lines])
    assert rows[1] == rows[0] and len(rows[0]) == 3
    events = []
    ttrace.GLOBAL_TRACER.register(events.append)
    try:
        tcodec.compress(TEXT[:1000], level=1)
    finally:
        ttrace.GLOBAL_TRACER.unregister(events.append)
    assert [(e.method, e.src_size, e.level) for e in events] == \
        [("compress", 1000, 1)]
    prog = ttrace.get_frame_progression()
    assert prog.ingested == prog.consumed == 1000


def test_progression_equals_jax():
    for data, level, target in ((TEXT, 1, 4096), (BIG, 9, 8192),
                                (TEXT, 19, 4096), (BIG, 3, None)):
        jcodec.compress(data, level=level, target_cblock_size=target)
        tcodec.compress(data, level=level, target_cblock_size=target)
        j, t = jtrace.get_frame_progression(), ttrace.get_frame_progression()
        assert (t.ingested, t.consumed, t.produced, t.flushed) == \
            (j.ingested, j.consumed, j.produced, j.flushed)


API = ("compress", "decompress", "compress_patch", "decompress_patch",
       "compress_bound", "find_frame_compressed_size",
       "get_dict_id_from_dict", "get_dict_id_from_frame",
       "get_frame_content_size", "is_frame", "ZstdError", "ZstdErrorCode",
       "CParams", "get_cparams", "xxh64", "register_sequence_producer",
       "__version__")


@pytest.mark.parametrize("name", API)
def test_top_level_api_names_zstd_tpus(name):
    assert name in zstd_tpu.__all__ and name in zstd_tpu_torch.__all__
    assert getattr(zstd_tpu_torch, name) is not None


def test_top_level_api_equals_jax():
    old = _mutated(TEXT)
    assert zstd_tpu_torch.compress(TEXT, level=4) == \
        zstd_tpu.compress(TEXT, level=4)
    blob = zstd_tpu_torch.compress_patch(TEXT, old, level=3)
    assert blob == zstd_tpu.compress_patch(TEXT, old, level=3)
    assert zstd_tpu_torch.decompress_patch(blob, old) == TEXT
    assert zstd_tpu_torch.decompress(zstd_tpu.compress(BIG)) == BIG
    assert zstd_tpu_torch.xxh64(BIG, 5) == zstd_tpu.xxh64(BIG, 5)
    assert dataclasses.astuple(zstd_tpu_torch.get_cparams(7, 10 ** 6)) == \
        dataclasses.astuple(zstd_tpu.get_cparams(7, 10 ** 6))
    with pytest.raises(zstd_tpu_torch.ZstdError):
        zstd_tpu_torch.decompress(b"\x28\xb5\x2f\xfd")
