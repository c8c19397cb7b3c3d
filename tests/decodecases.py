"""Decode inputs shared by tests/test_torch_decode.py and chip_smoke.py.

Imports neither JAX nor zstd_tpu, so chip_smoke.py may use it on the card.
"""

from __future__ import annotations

import numpy as np


def underrun_frame(frame: bytes) -> bytes:
    """The frame with its first literal stream's top 64 bytes zeroed and its
    sentinel moved to bit 0 of the last byte: the stream holds fewer bits
    and its first symbols decode to the longest code, so it under-runs."""
    from zstd_tpu_torch import device_decoder
    s = device_decoder._parse_frame(frame, 0, 31).lanes[0][0]
    end = frame.index(s) + len(s) - 1
    bad = bytearray(frame)
    bad[end - 64:end] = bytes(64)
    bad[end] = 1
    return bytes(bad)


def overrun_frame(frame: bytes) -> bytes:
    """The frame with its first compressed block's literal count one less
    than its sequences' literal lengths add up to: the literals header's
    regenerated size is cut by the block's trailing literals plus one (for
    raw literals also that many literal bytes, and the block size with
    them). A decoder must refuse it."""
    from zstd_tpu_torch import device_decoder
    fhd = frame[4]
    single = bool(fhd & 0x20)
    pos = 5 + (0 if single else 1) + (0, 1, 2, 4)[fhd & 3] + \
        (1 if single else 0, 2, 4, 8)[fhd >> 6]
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        btype, bsize = (bh >> 1) & 3, bh >> 3
        if btype == 2:
            break
        assert not bh & 1, "the frame has no compressed block"
        pos += 3 + (1 if btype == 1 else bsize)
    # the frame up to this block, made its last: its trailing literals are
    # the last pseudo-sequence (match length 0) of the parse
    head = bytearray(frame[:pos + 3 + bsize])
    head[pos] |= 1
    pf = device_decoder._parse_frame(bytes(head), 0, 31)
    assert pf.ml.any(), "the block has no sequences"
    cut = 1 + (int(pf.ll[-1]) if pf.ml[-1] == 0 else 0)
    lit = pos + 3
    ltype, sf = frame[lit] & 3, (frame[lit] >> 2) & 3
    if ltype < 2:                       # raw or RLE: the size fills the header
        hs, shift = ((1, 3), (2, 4), (1, 3), (3, 4))[sf]
        width = 8 * hs - shift
    else:                               # Huffman: regenerated size first
        hs, shift, width = (3, 3, 4, 5)[sf], 4, (10, 10, 14, 18)[sf]
    hv = int.from_bytes(frame[lit:lit + hs], "little")
    regen = (hv >> shift) & ((1 << width) - 1)
    bad = bytearray(frame)
    bad[lit:lit + hs] = (hv - (cut << shift)).to_bytes(hs, "little")
    if ltype == 0:
        del bad[lit + hs + regen - cut:lit + hs + regen]
        bad[pos:pos + 3] = (bh - 8 * cut).to_bytes(3, "little")
    return bytes(bad)


def sequence_sections(blocks: bytes) -> list[bytes]:
    """The sequences sections of the compressed blocks in `blocks` (a
    frame's bytes from its first block header), each cut where its literals
    section ends, as the device decode's host parse cuts it."""
    out, p, last = [], 0, False
    while not last:
        bh = int.from_bytes(blocks[p:p + 3], "little")
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        p += 3
        if btype == 2:
            b = blocks[p:p + bsize]
            ltype, sf = b[0] & 3, (b[0] >> 2) & 3
            if ltype < 2:       # raw or RLE: the size fills the header
                lh = (1, 2, 1, 3)[sf]
                regen = int.from_bytes(b[:lh], "little") >> (3 if lh == 1
                                                              else 4)
                used = lh + (regen if ltype == 0 else 1)
            else:               # Huffman: then the compressed size
                lh, shift, width = ((3, 14, 10), (3, 14, 10), (4, 18, 14),
                                    (5, 22, 18))[sf]
                v = int.from_bytes(b[:lh], "little")
                used = lh + ((v >> shift) & ((1 << width) - 1))
            out.append(b[used:])
        p += 1 if btype == 1 else bsize
    return out


def repeated_pieces(n: int = 200_000, seed: int = 0) -> bytes:
    """n bytes of 48-byte random pieces, each repeated once: a level-1 frame
    of it has raw literals (random bytes do not compress) and one match of
    48 bytes at offset 48 a piece."""
    rng = np.random.default_rng(seed)
    pieces = rng.integers(0, 256, (n // 96 + 1, 48), dtype=np.uint8)
    return np.concatenate([pieces, pieces], axis=1).reshape(-1)[:n].tobytes()


def nested_data() -> bytes:
    """101 chunks of 256 bytes, each the previous one with one byte changed:
    its matches copy the previous chunk, so dependency chains run up to 100
    matches deep (7 doubling rounds and one more to see no change)."""
    rng = np.random.default_rng(5)
    chunk = bytearray(rng.integers(0, 256, 256, np.uint8).tobytes())
    out = bytearray(chunk)
    for c in range(100):
        chunk[(c * 37) % 256] ^= 0x5A
        out += chunk
    return bytes(out)


def long_code_table():
    """(lut_sym, lut_len) u8[2048] of a tableLog-11 Huffman table whose
    rarest symbols take 11-bit codes: random bytes decode to long codes and
    a walk begun at a wrong bit falls into step late."""
    from zstd_tpu_torch.device_decoder import _expand_lut
    from zstd_tpu_torch.format.huffman import build_huf_ctable, build_huf_dtable
    hist = np.maximum((1e6 * 0.62 ** np.arange(256)).astype(np.int64), 1)
    hist = hist[np.random.default_rng(3).permutation(256)]
    ct = build_huf_ctable(hist, 255, 11)
    return _expand_lut(build_huf_dtable(ct.nb_bits, 256, ct.table_log))


def adversarial_group(g: dict, seed: int = 0) -> dict:
    """Huffman lanes that a well-formed frame lacks, built from the lanes of
    a group g (device_decoder._group_inputs of at least four lanes; numpy),
    at g's byte_cap and twice its max_syms: four real lanes as they are,
    one asked for 64 symbols more than it holds (under-run), one for 100
    fewer (over-long: final > 0), one for none, a 40-byte lane (shorter
    than one 512-position segment), three lanes of random bytes under
    `long_code_table`, a start past the last window, a negative start and
    a padding lane. Also pool segments over the lanes: each lane with
    symbols gets a dev segment of its n_syms, and every other one is
    followed by a 100-byte host segment. Returns the arguments of
    literal_pool (and of huf_decode_streams) as numpy arrays and ints."""
    rng = np.random.default_rng(seed)
    sb0, bits0, nsy0 = g["sb"], g["start_bits"], g["n_syms"]
    byte_cap = sb0.shape[1]
    max_syms = 2 * g["max_syms"]
    lut_sym, lut_len = long_code_table()
    T0 = g["lut_sym"].shape[0]
    lanes = []                                      # (row, bits, n, table)

    def real(i, n=None):
        return (sb0[i], int(bits0[i]), int(nsy0[i]) if n is None else n,
                int(g["lane_tab"][i]))

    lanes += [real(i) for i in range(4)]
    lanes.append(real(0, int(nsy0[0]) + 64))
    lanes.append(real(1, int(nsy0[1]) - 100))
    lanes.append(real(2, 0))
    nbytes = (int(bits0[3]) + 8) // 8
    short = np.zeros(byte_cap, np.uint8)
    short[:40] = sb0[3, nbytes - 40:nbytes]
    lanes.append((short, 8 * 39 + int(short[39]).bit_length() - 1, 60,
                  int(g["lane_tab"][3])))
    for n in (20000, 5000, max_syms):
        row = rng.integers(0, 256, byte_cap, np.uint8)
        row[-1] |= 0x80
        lanes.append((row, 8 * byte_cap - 1, n, T0))
    lanes.append(real(1, 3000)[:1] + (8 * byte_cap + 777, 3000, 0))
    lanes.append(real(1, 100)[:1] + (-5, 100, 0))
    lanes.append((np.zeros(byte_cap, np.uint8), 0, 0, 0))
    segs, host, pool = [], [], 0
    for i, (_, _, n, _) in enumerate(lanes):
        n = min(n, max_syms)
        if n > 0:
            segs.append((pool, i, 0, True))
            pool += n
        if i % 2:
            segs.append((pool, 0, len(host), False))
            host += rng.integers(0, 256, 100, np.uint8).tolist()
            pool += 100
    npad = 4096
    while npad < pool:
        npad *= 2
    # three padding segments at npad close the list
    col = lambda k, dt: np.array([s[k] for s in segs] + [0] * 3, dt)
    seg_start = col(0, np.int32)
    seg_start[len(segs):] = npad
    return dict(
        sb=np.stack([r for r, *_ in lanes]),
        start_bits=np.array([b for _, b, _, _ in lanes], np.int32),
        n_syms=np.array([n for _, _, n, _ in lanes], np.int32),
        lut_sym=np.concatenate([g["lut_sym"], lut_sym[None]]),
        lut_len=np.concatenate([g["lut_len"], lut_len[None]]),
        lane_tab=np.array([t for *_, t in lanes], np.int32),
        seg_start=seg_start, seg_lane=col(1, np.int32),
        seg_src=col(2, np.int32), seg_is_dev=col(3, bool),
        host_lits=np.array(host, np.uint8), nb_lit=pool,
        max_syms=max_syms, npad=npad)


def exec_case(seed: int, n: int, h: int, cut: int):
    """Random valid sequences over n output bytes for the executor:
    literal-only pseudo-sequences, overlapping matches (off < ml), matches
    into an h-byte history; out_len = total - cut. Returns (lits u8[n],
    ll, ml, off i32[seq_cap], nb_seq, out_len, history u8[h])."""
    rng = np.random.default_rng(seed)
    ll, ml, off = [], [], []
    pos = 0
    while True:
        a = int(rng.integers(0, 20))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            m, d = 0, 1
        else:
            m = int(rng.integers(3, 60))
            reach = pos + a + h
            d = int(rng.integers(1, min(8, reach) + 1)) if kind == 1 \
                else int(rng.integers(1, reach + 1))
        if pos + a + m > n - 40:
            break
        ll.append(a)
        ml.append(m)
        off.append(d)
        pos += a + m
    cap = 4096
    while cap < len(ll):
        cap *= 2
    pad = lambda a: np.pad(np.array(a, np.int32), (0, cap - len(a)))
    return (rng.integers(0, 256, n, np.uint8), pad(ll), pad(ml), pad(off),
            len(ll), pos - cut, rng.integers(0, 256, h, np.uint8))
