"""Deterministic multi-megabyte mixed corpus: the benchmark's stand-in for
silesia.tar, which is not in the repository and cannot be fetched.

A frozen copy of tests/bigcorpus.py (see README.md for its origin commit),
with one change: big_corpus takes a seed, and each segment's generator but
image16's gets a seed drawn from it, so every seed gives the same eight
classes at the same sizes with other content; seed=None gives the original
corpus. The raster keeps its original seed in every corpus: its walk,
clipped at the raster's bounds, compresses 1.9-8.6 at level 1 by seed
(measured), so a seed of its own would change how much work a call is, and
the original's 5.07 keeps the corpus near silesia's level-1 ratio.

Segment map (silesia analog in parens):
  text_en     (dickens/webster)  English-like word stream, paragraphs
  source_code (samba)            C-like source, heavy token reuse
  xml_nested  (xml)              nested tagged records, incrementing ids
  db_records  (osdb)             fixed-stride binary records
  image16     (mr/x-ray)         smooth 16-bit random-walk raster
  exec_like   (mozilla/ooffice)  opcode-ish bytes + embedded strings
  repetitive  (nci)              near-duplicate lines, small edits
  near_random (sao)              high-entropy records, mild structure
"""

from __future__ import annotations

import numpy as np

_WORDS = (
    b"the of and to a in that it is was he for on are as with his they at be "
    b"this have from or one had by word but not what all were we when your "
    b"can said there use an each which she do how their if will up other "
    b"about out many then them these so some her would make like him into "
    b"time has look two more write go see number no way could people my than "
    b"first water been call who oil its now find long down day did get come "
    b"made may part over new sound take only little work know place year "
    b"live me back give most very after thing our just name good sentence "
    b"man think say great where help through much before line right too "
    b"mean old any same tell boy follow came want show also around form "
    b"three small set put end does another well large must big even such "
    b"because turn here why ask went men read need land different home us "
    b"move try kind hand picture again change off play spell air away "
    b"animal house point page letter mother answer found study still learn "
    b"should america world high every near add food between own below "
    b"country plant last school father keep tree never start city earth eye "
    b"light thought head under story saw left dont few while along might "
    b"close something seem next hard open example begin life always those "
    b"both paper together got group often run important until children side "
    b"feet car mile night walk white sea began grow took river four carry "
    b"state once book hear stop without second later miss idea enough eat "
    b"face watch far indian really almost let above girl sometimes mountain "
).split()


def text_en(n: int, seed: int = 0) -> bytes:
    """Zipf-weighted word stream with sentence/paragraph structure."""
    rng = np.random.default_rng(seed)
    k = len(_WORDS)
    # Zipf-ish weights
    w = 1.0 / (np.arange(1, k + 1) ** 0.9)
    w /= w.sum()
    est_words = n // 5 + 64
    idx = rng.choice(k, size=est_words, p=w)
    words = [_WORDS[i] for i in idx]
    sent_end = rng.random(est_words) < 0.08
    para_end = rng.random(est_words) < 0.01
    out = bytearray()
    cap = True
    for wd, se, pe in zip(words, sent_end, para_end):
        if cap:
            wd = wd[:1].upper() + wd[1:]
            cap = False
        out += wd
        if pe:
            out += b".\n\n"
            cap = True
        elif se:
            out += b". "
            cap = True
        else:
            out += b" "
        if len(out) >= n:
            break
    while len(out) < n:
        out += b"the end. "
    return bytes(out[:n])


def source_code(n: int, seed: int = 1) -> bytes:
    """C-like source: repeated idioms, identifiers from a small pool."""
    rng = np.random.default_rng(seed)
    idents = [b"count", b"state", b"buffer", b"offset", b"length", b"index",
              b"result", b"value", b"ptr", b"size", b"ctx", b"table",
              b"symbol", b"stream", b"window", b"match"]
    types = [b"int", b"size_t", b"U32", b"BYTE const*", b"unsigned"]
    tmpl = [
        b"static %b %b_%b(%b %b, %b %b) {\n",
        b"    if (%b > %b) return %b;\n",
        b"    for (%b = 0; %b < %b; %b++) {\n",
        b"        %b[%b] = %b[%b] + %b;\n",
        b"    }\n",
        b"    return %b;\n",
        b"}\n\n",
    ]
    out = bytearray()
    while len(out) < n:
        for t in tmpl:
            need = t.count(b"%b")
            args = []
            for _ in range(need):
                pool = idents if rng.random() < 0.8 else types
                args.append(pool[rng.integers(len(pool))])
            out += t % tuple(args) if need else t
        if len(out) >= n:
            break
    return bytes(out[:n])


def xml_nested(n: int, seed: int = 2) -> bytes:
    rng = np.random.default_rng(seed)
    out = bytearray(b"<?xml version=\"1.0\"?>\n<catalog>\n")
    rec = 0
    while len(out) < n:
        price = int(rng.integers(100, 99999))
        qty = int(rng.integers(1, 500))
        name = _WORDS[int(rng.integers(len(_WORDS)))]
        out += (b"  <record id=\"%08d\">\n"
                b"    <name>%b</name>\n"
                b"    <price currency=\"USD\">%d.%02d</price>\n"
                b"    <quantity>%d</quantity>\n"
                b"    <flags active=\"true\" visible=\"false\"/>\n"
                b"  </record>\n"
                % (rec, name, price // 100, price % 100, qty))
        rec += 1
    out += b"</catalog>\n"
    return bytes(out[:n])


def db_records(n: int, seed: int = 3) -> bytes:
    """64-byte fixed-stride records: ids, timestamps, enum bytes, floats."""
    rng = np.random.default_rng(seed)
    nrec = n // 64 + 1
    rec = np.zeros((nrec, 16), dtype=np.uint32)
    rec[:, 0] = np.arange(nrec, dtype=np.uint32)           # id
    rec[:, 1] = 1700000000 + np.arange(nrec) * 37          # timestamp
    rec[:, 2] = rng.integers(0, 16, nrec)                  # enum
    rec[:, 3] = rng.integers(0, 4, nrec)                   # flag
    vals = (rng.standard_normal(nrec) * 100 + 5000).astype(np.float32)
    rec[:, 4] = vals.view(np.uint32)
    rec[:, 5:8] = 0                                        # reserved
    rec[:, 8] = rec[:, 0] * 7 + 3                          # derived key
    rec[:, 9:12] = np.array([0x20202020, 0x41424344, 0x2D2D2D2D], np.uint32)
    rec[:, 12] = rng.integers(0, 1000, nrec)
    rec[:, 13:16] = 0
    return rec.tobytes()[:n]


def image16(n: int, seed: int = 4) -> bytes:
    """Smooth 16-bit raster: 2-D random walk (mr/x-ray-like)."""
    rng = np.random.default_rng(seed)
    npix = n // 2 + 1
    steps = rng.integers(-12, 13, npix).astype(np.int32)
    sig = np.cumsum(steps) + 2048
    sig = np.clip(sig, 0, 4095).astype(np.uint16)
    return sig.tobytes()[:n]


def exec_like(n: int, seed: int = 5) -> bytes:
    """Opcode-ish byte stream: skewed byte histogram, recurring 4-byte
    patterns (call/jump targets), occasional ASCII islands."""
    rng = np.random.default_rng(seed)
    # skewed opcode distribution
    ops = rng.choice(
        np.array([0x48, 0x89, 0x8B, 0xE8, 0x0F, 0xC3, 0x55, 0x5D, 0xFF,
                  0x83, 0x45, 0x31, 0x85, 0x74, 0x75, 0x90], np.uint8),
        size=n, p=None)
    buf = np.asarray(ops, dtype=np.uint8).copy()
    # sprinkle little-endian offsets from a small pool (relocation-like)
    pool = rng.integers(0, 1 << 20, 256).astype(np.uint32)
    nsites = n // 16
    sites = rng.integers(0, max(n - 4, 1), nsites)
    vals = pool[rng.integers(0, 256, nsites)]
    v = vals.view(np.uint8).reshape(-1, 4)
    for k in range(4):
        buf[np.minimum(sites + k, n - 1)] = v[:, k]
    # ascii islands
    isl = text_en(n // 20, seed + 100)
    at = rng.integers(0, max(n - 256, 1), len(isl) // 256)
    ia = np.frombuffer(isl, np.uint8)
    for j, a in enumerate(at):
        seg = ia[j * 256:(j + 1) * 256]
        buf[a:a + len(seg)] = seg
    return buf.tobytes()[:n]


def repetitive(n: int, seed: int = 6) -> bytes:
    """nci-like: long runs of near-duplicate lines with counter edits."""
    rng = np.random.default_rng(seed)
    out = bytearray()
    base = bytearray(b"C1=CC=CC=C1 benzene ring fragment energy -34.52017 "
                     b"dipole 0.000 quadrupole 1.334 code ")
    i = 0
    while len(out) < n:
        line = bytes(base) + b"%07d\n" % i
        reps = int(rng.integers(3, 40))
        out += line * reps
        if rng.random() < 0.3:
            p = int(rng.integers(0, len(base)))
            base[p] = 0x41 + int(rng.integers(26))
        i += 1
    return bytes(out[:n])


def near_random(n: int, seed: int = 7) -> bytes:
    """sao-like: mostly-incompressible records with a periodic key."""
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 256, n, dtype=np.uint8)
    # every 28 bytes, a 4-byte incrementing key gives slight structure
    nrec = n // 28
    keys = np.arange(nrec, dtype=np.uint32).view(np.uint8).reshape(-1, 4)
    for k in range(4):
        buf[np.arange(nrec) * 28 + k] = keys[:, k]
    return buf.tobytes()[:n]


SEGMENTS = [
    ("text_en", text_en),
    ("source_code", source_code),
    ("xml_nested", xml_nested),
    ("db_records", db_records),
    ("image16", image16),
    ("exec_like", exec_like),
    ("repetitive", repetitive),
    ("near_random", near_random),
]


# segments that keep their original seed in a seeded corpus
FIXED = ("image16",)


def segment_seeds(seed: int | None) -> list:
    """The seed of each segment: the original ones (0-7) for None, else
    drawn from `seed` (any whole number), but the FIXED segments'."""
    if seed is None:
        return list(range(len(SEGMENTS)))
    ss = np.random.SeedSequence(seed % (1 << 64))
    drawn = ss.generate_state(len(SEGMENTS), np.uint32)
    return [i if name in FIXED else int(x)
            for i, ((name, _), x) in enumerate(zip(SEGMENTS, drawn))]


def big_corpus(total: int = 8 * 1024 * 1024, seed: int | None = None) -> bytes:
    """The pinned mixed corpus: equal-size segments, fixed order; segment
    seeds from `seed` (None: the original seeds)."""
    seg = total // len(SEGMENTS)
    parts = [fn(seg, s) for (_, fn), s in zip(SEGMENTS, segment_seeds(seed))]
    parts[-1] = parts[-1][: total - seg * (len(SEGMENTS) - 1)]
    blob = b"".join(parts)
    return blob[:total]

