"""zstd_tpu_torch's sharded long-distance matcher and the host frame encoder
of --long, on the CPU, against zstd_tpu.

- The plain versions of the two kernels (`ops.ldm.fingerprint_plain` /
  `anchor_keys_plain`, `lookback_plain`) against JAX's `_fingerprint_hi`
  and look-back and the host LdmState.
- `parallel.ldm_sharded.ShardedLdmState` in gloo groups of 1, 2 and 3
  spawned ranks (tests/torchdist.py, job kind "ldm") against JAX's
  ShardedLdmState on meshes of 1, 2 and 3 and the host LdmState: anchors,
  candidates and find_long_matches of every block; the cap drop; the
  reference's halo-wrap fault (ROADMAP §3), which the port does not share.
- `compress_long_sharded` frames against zstd_tpu's (its C library loaded)
  at levels 1 and -1 on 4 MiB, and 3, 5, 9 and 19 on 512 KiB of the long
  corpus (the chain-lazy gap parser, the DP and the seqstore splitting),
  the same at world sizes 1 and 2; level 19 on the short inputs.
- The host copies on that path (the C fast parser, the Huffman, literal,
  sequence, block and split encoders) against zstd_tpu's C branches.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import zstd_tpu
from tests.conftest import gen_mixed, gen_text
from tests.longcorpus import long_corpus
from tests.torchdist import run_groups
from zstd_tpu import params as jparams
from zstd_tpu.format import block as jblock
from zstd_tpu.format import frame as jframe
from zstd_tpu.format import huffman as jhuf
from zstd_tpu.format import ldm as jldm
from zstd_tpu.format import literals as jlit
from zstd_tpu.format import sequences as jseq
from zstd_tpu.native import get_native
from tests.refnative import reference_native
from zstd_tpu.parallel import ldm_sharded as jl
from zstd_tpu.parallel.shard_compress import make_mesh
from zstd_tpu_torch import params as tparams
from zstd_tpu_torch.format import bitstream as tbits
from zstd_tpu_torch.format import block as tblock
from zstd_tpu_torch.format import frame as tframe
from zstd_tpu_torch.format import huffman as thuf
from zstd_tpu_torch.format import ldm as tldm
from zstd_tpu_torch.format import literals as tlit
from zstd_tpu_torch.format import opt as topt
from zstd_tpu_torch.format import sequences as tseq
from zstd_tpu_torch.ops import ldm as tops
from zstd_tpu_torch.parallel import ldm_sharded as tl

WORLDS = (1, 2, 3)
FRAME_WORLDS = (1, 2)
BS = 128 * 1024
# test_ldm_sharded.test_sharded_discovery_matches_host_exactly's corpus
MIXED = (gen_text(700_000, seed=71) + gen_mixed(300_000, seed=72)) * 2
# one 16-byte period holding one anchor: 4,092 anchors of one key, past
# cap (2,048 at one rank, 512 an owner at two) in its owner
PERIODIC = np.tile(np.random.default_rng(0).integers(0, 256, 16,
                                                     dtype=np.uint8),
                   4096).tobytes()
# sizes at which the last shard's halo wraps onto shard 0's head in JAX
# (ROADMAP §3): rng(5) gains anchor 153,577 there, rng(4) loses 153,595
HALO = {f"rng{s}_{n}": np.random.default_rng(s).integers(
            0, 256, n, dtype=np.uint8).tobytes()
        for s, n in ((5, 153_663), (5, 153_654), (5, 153_645),
                     (4, 153_663))}
LONG = long_corpus(4 * 1024 * 1024, seg=1024 * 1024)
LEVELS = (1, -1)
# levels 3-22: the inner parsers of strategies 2-9 (chain-lazy, the DP) and
# the seqstore splitting of strategy 5 and up
LONG_SMALL = long_corpus(512 * 1024, seg=128 * 1024)
SMALL_LEVELS = (3, 5, 9, 19)
SHORT = {"empty": b"", "tiny": b"abc" * 30}
LDM_JOBS = {"mixed": (MIXED, 21), "periodic": (PERIODIC, 20),
            **{k: (v, 21) for k, v in HALO.items()}}


def _u8(data: bytes) -> np.ndarray:
    return np.frombuffer(data, dtype=np.uint8)


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    """{world: {name: rank 0's result}}: every discovery and the short
    inputs' frames on worlds 1-3 (one spawned group per world size)."""
    jobs = [(name, "ldm", dict(data=d, window_log=w))
            for name, (d, w) in LDM_JOBS.items()]
    jobs += [(name, "long", dict(data=d, checksum=True))
             for name, d in SHORT.items()]
    jobs += [(f"{name}19", "long", dict(data=d, level=19, checksum=True))
             for name, d in SHORT.items()]
    return run_groups(WORLDS, str(tmp_path_factory.mktemp("ldm")), jobs)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """{world: {f"long{level}": frame}} of LONG and of LONG_SMALL on worlds
    1 and 2."""
    jobs = [(f"long{lv}", "long", dict(data=LONG, level=lv, long_log=24))
            for lv in LEVELS]
    jobs += [(f"small{lv}", "long", dict(data=LONG_SMALL, level=lv,
                                          long_log=20))
             for lv in SMALL_LEVELS]
    return run_groups(FRAME_WORLDS, str(tmp_path_factory.mktemp("long")),
                      jobs)


_JAX = {}


def _jax_state(name: str, k: int):
    key = (name, k)
    if key not in _JAX:
        data, wlog = LDM_JOBS[name]
        _JAX[key] = jl.ShardedLdmState(_u8(data), wlog, mesh=make_mesh(k))
    return _JAX[key]


def _matches(st, full: np.ndarray, host=None) -> list:
    n = len(full)
    out = []
    for b0 in range(0, n, BS):
        if host is not None:
            st.insert_upto(b0)
        out.append(st.find_long_matches(b0, min(b0 + BS, n)))
    return out


# ---- kernel 7's plain version ----------------------------------------------

FP_INPUTS = {
    "random": lambda n: np.random.default_rng(n).integers(0, 256, n,
                                                          dtype=np.uint8),
    "zeros": lambda n: np.zeros(n, np.uint8),
    "text": lambda n: _u8(gen_text(n, seed=3)),
}


@pytest.mark.parametrize("n", [64, 200, 4_159, 70_001])
@pytest.mark.parametrize("kind", sorted(FP_INPUTS))
def test_fingerprint_plain_equals_jax_and_host(kind, n):
    full = FP_INPUTS[kind](n)
    m = n - 63
    got = tops.fingerprint_plain(torch.from_numpy(full.copy()), m).numpy()
    want = np.asarray(jl._fingerprint_hi(jnp.asarray(full), m)).astype(
        np.int64)
    host = jldm.LdmState(full, 27)
    assert np.array_equal(got, want)
    assert np.array_equal(got, (host.h >> np.uint64(32)).astype(np.int64))
    # the predicate and the key on a chunk (the halo zero-filled), with a
    # valid count below m
    ext = torch.from_numpy(np.concatenate([full, np.zeros(63, np.uint8)]))
    flag, key = tops.anchor_keys_plain(ext, m - m // 3)
    flag = flag.numpy()
    anchors = host.anchors[host.anchors < m - m // 3]
    assert np.array_equal(np.nonzero(flag)[0], anchors)
    want_key = (host.h[anchors] >> np.uint64(37)) & np.uint64(0xFFFFF)
    assert np.array_equal(key.numpy()[anchors], want_key.astype(np.int32))
    assert tops.anchor_keys(ext, m - m // 3)[0].equal(torch.from_numpy(flag))


# ---- kernel 8's plain version ----------------------------------------------

def _jax_rows(data: bytes, wlog: int, k: int):
    """JAX `_discover`'s raw rows (pos [k, k·cap], cand [k, k·cap, 4]) with
    ShardedLdmState's layout."""
    full = _u8(data)
    mesh = make_mesh(k)
    window = 1 << wlog
    lay = tl.layout(len(full), k, window)
    m = lay["m"]
    chunks = np.zeros((k, m + 64), np.uint8)
    valid = np.zeros(k, np.int32)
    gbase = np.zeros(k, np.int32)
    for s in range(k):
        a = s * m
        b = min(a + m + 64, len(full))
        if a < len(full):
            chunks[s, :b - a] = full[a:b]
        valid[s] = min(max(lay["n_pos"] - a, 0), m)
        gbase[s] = a
    pos, cand = jl._discover(
        jax.device_put(jnp.asarray(chunks), NamedSharding(mesh, P("dp",
                                                                  None))),
        jax.device_put(jnp.asarray(valid), NamedSharding(mesh, P("dp"))),
        jax.device_put(jnp.asarray(gbase), NamedSharding(mesh, P("dp"))),
        mesh, k, lay["cap"], lay["block_size"], window, axis="dp")
    return np.asarray(pos), np.asarray(cand), lay


@pytest.mark.parametrize("k", WORLDS)
def test_lookback_plain_equals_jax(k):
    """Each owner row of JAX's `_discover` (its look-back over its own
    (key, pos) sort) from the keys of that row's positions."""
    full = _u8(MIXED)
    pos, cand, lay = _jax_rows(MIXED, 21, k)
    h = jldm.LdmState(full, 21).h
    for s in range(k):
        p = pos[s]
        key = np.where(p >= 0, (h[np.maximum(p, 0)] >> np.uint64(37))
                       & np.uint64(0xFFFFF), 0).astype(np.int32)
        entries = tops.owner_entries(torch.from_numpy(key),
                                     torch.from_numpy(p.copy()))
        assert torch.equal(entries, torch.sort(entries).values)
        got_p, got_c = tops.lookback_plain(entries, lay["block_size"],
                                           1 << 21)
        assert np.array_equal(got_p.numpy(), p)
        assert np.array_equal(got_c.numpy(), cand[s])
        assert (got_c >= 0).any()
        w_p, w_c = tops.lookback(entries, lay["block_size"], 1 << 21)
        assert torch.equal(w_p, got_p) and torch.equal(w_c, got_c)


def test_lookback_edges():
    """Fewer entries than the look-back, the sentinel, a candidate in the
    anchor's own block (not taken), one past the window (not taken), and
    more than four hits (the nearest four)."""
    k = 7
    rows = [(k, 10), (k, 130_000), (k, 140_000), (k, 150_000),
            (k, 160_000), (k, 170_000), (k, 300_000), (k, 300_100)]
    key = torch.tensor([r[0] for r in rows] + [0], dtype=torch.int32)
    pos = torch.tensor([r[1] for r in rows] + [-1], dtype=torch.int32)
    entries = torch.sort(tops.owner_entries(key, pos)).values
    p, c = tops.lookback_plain(entries, 1 << 16, 200_000)
    assert p.tolist() == [10, 130_000, 140_000, 150_000, 160_000, 170_000,
                          300_000, 300_100, -1]
    assert c[:3].tolist() == [[-1] * 4, [10, -1, -1, -1],
                              [130_000, 10, -1, -1]]
    assert c[3].tolist() == [130_000, 10, -1, -1]   # 140,000: its block
    assert c[6].tolist() == [170_000, 160_000, 150_000, 140_000]
    assert c[7].tolist() == c[6].tolist()      # 300,000 is in its block
    assert c[8].tolist() == [-1] * 4
    p2, c2 = tops.lookback_plain(entries[:2], 1 << 16, 1000)
    assert c2.tolist() == [[-1] * 4] * 2       # 130,000 - 10 > window


# ---- discovery --------------------------------------------------------------

@pytest.mark.parametrize("world", WORLDS)
def test_discovery_equals_jax_and_host(port, world):
    full = _u8(MIXED)
    got = port[world]["mixed"]
    jx = _jax_state("mixed", world)
    host = jldm.LdmState(full, 21)
    assert np.array_equal(got["anchors"], jx.anchors)
    assert np.array_equal(got["cands"], jx.cands)
    assert np.array_equal(got["anchors"], host.anchors)
    assert got["matches"] == _matches(jx, full)
    assert got["matches"] == _matches(host, full, host=True)
    assert sum(map(len, got["matches"])) > 0
    # the port's own host copy agrees
    th = tldm.LdmState(full, 21)
    assert np.array_equal(th.anchors, host.anchors)
    assert np.array_equal(th.h, host.h)
    assert _matches(th, full, host=True) == got["matches"]


@pytest.mark.parametrize("world", (1, 2))
def test_cap_drop_equals_jax(port, world):
    full = _u8(PERIODIC)
    host = jldm.LdmState(full, 20)
    lay = tl.layout(len(full), world, 1 << 20)
    keys = (host.h[host.anchors] >> np.uint64(37)) & np.uint64(0xFFFFF)
    owners = np.minimum(keys.astype(np.int64) >> tl.own_log(world),
                        world - 1)
    sender = host.anchors // lay["m"]
    per = np.bincount(sender * world + owners, minlength=world * world)
    assert per.max() > lay["cap"], "no owner passes cap"
    got = port[world]["periodic"]
    jx = _jax_state("periodic", world)
    assert len(got["anchors"]) < len(host.anchors)
    assert len(got["anchors"]) == min(per.max(), lay["cap"]) * world
    assert np.array_equal(got["anchors"], jx.anchors)
    assert np.array_equal(got["cands"], jx.cands)
    assert got["matches"] == _matches(jx, full)


@pytest.mark.parametrize("name", sorted(HALO))
def test_halo_wrap_pins_reference_fault(port, name):
    """JAX's ppermute halo gives the last shard shard 0's head: its anchors
    near the end differ from the host LdmState's. The port reads the
    input's own bytes there and equals the host."""
    full = _u8(HALO[name])
    host = jldm.LdmState(full, 21)
    want = _matches(jldm.LdmState(full, 21), full, host=True)
    jx = _jax_state(name, 2)
    differ = set(jx.anchors.tolist()) ^ set(host.anchors.tolist())
    # only positions whose window reaches the last shard's halo differ
    n_pos = len(full) - 63
    m = tl.layout(len(full), 2, 1 << 21)["m"]
    assert differ and min(differ) >= 2 * m - 55 and max(differ) < n_pos
    if name.startswith("rng5"):
        assert 153_577 in set(jx.anchors.tolist()) - set(
            host.anchors.tolist())
    for world in WORLDS:
        got = port[world][name]
        assert np.array_equal(got["anchors"], host.anchors), world
        assert got["matches"] == want


# ---- frames -------------------------------------------------------------------

_JFRAMES = {}


def _jax_frame(level: int) -> bytes:
    if level not in _JFRAMES:
        _JFRAMES[level] = jl.compress_long_sharded(
            LONG, level=level, long_log=24, mesh=make_mesh(1))
    return _JFRAMES[level]


def test_long_corpus_is_clear_of_the_halo_fault():
    """The frames below hold the port to JAX: their discovery must not reach
    the reference fault at these sizes."""
    full = _u8(LONG)
    host = jldm.LdmState(full, 24)
    for k in (1, 2):
        jx = jl.ShardedLdmState(full, 24, mesh=make_mesh(k))
        assert np.array_equal(jx.anchors, host.anchors)


@pytest.mark.parametrize("world", FRAME_WORLDS)
@pytest.mark.parametrize("level", LEVELS)
def test_frames_equal_jax(frames, level, world):
    assert reference_native() is not None
    want = _jax_frame(level)
    got = frames[world][f"long{level}"]
    assert got == want
    assert zstd_tpu.decompress(got) == LONG
    assert len(got) < len(LONG) // 3


@pytest.mark.parametrize("level", LEVELS)
def test_frames_same_at_every_world(frames, level):
    assert len({frames[w][f"long{level}"] for w in FRAME_WORLDS}) == 1


_JSMALL = {}


@pytest.mark.parametrize("world", FRAME_WORLDS)
@pytest.mark.parametrize("level", SMALL_LEVELS)
def test_frames_at_levels_3_to_22_equal_jax(frames, level, world):
    """The gaps between long matches parsed by the level's own inner parser
    (chain-lazy at strategies 2-5, the DP above), cut by the seqstore
    splitter from strategy 5, and the same frame at every world size."""
    if level not in _JSMALL:
        _JSMALL[level] = jl.compress_long_sharded(
            LONG_SMALL, level=level, long_log=20, mesh=make_mesh(1))
    got = frames[world][f"small{level}"]
    assert got == _JSMALL[level]
    assert zstd_tpu.decompress(got) == LONG_SMALL
    assert len(got) < len(LONG_SMALL) // 8


@pytest.mark.parametrize("name", ["empty", "tiny"])
def test_short_inputs_pin_reference_fault(port, name):
    """Below 320 bytes one shard's S·cap = 8 entries are fewer than the
    12-deep look-back, and JAX's `_discover` fails on a mesh of 1 (its
    shifted copies grow past the row; ROADMAP §3). On a mesh of 2 it runs;
    the port's frames equal that one at every world size and decode."""
    data = SHORT[name]
    with pytest.raises(TypeError):
        jl.compress_long_sharded(data, checksum=True, mesh=make_mesh(1))
    want = jl.compress_long_sharded(data, checksum=True, mesh=make_mesh(2))
    for w in WORLDS:
        assert port[w][name] == want
    assert zstd_tpu.decompress(want) == data
    assert tl.compress_long_sharded(data, checksum=True, device="cpu") == want


@pytest.mark.parametrize("name", sorted(SHORT))
def test_short_inputs_at_level_19(port, name):
    """The same inputs through the keep-min level's host path (the mesh-1
    fault stays pinned above): equal to JAX's mesh-2 frame at every world
    size."""
    data = SHORT[name]
    want = jl.compress_long_sharded(data, level=19, checksum=True,
                                    mesh=make_mesh(2))
    for w in WORLDS:
        assert port[w][f"{name}19"] == want
    assert zstd_tpu.decompress(want) == data
    assert tl.compress_long_sharded(data, level=19, checksum=True,
                                    device="cpu") == want


def test_world_of_one_on_the_cpu():
    """No process group: a world of one, the same state as the groups'."""
    st = tl.ShardedLdmState(_u8(MIXED), 21, device="cpu")
    jx = _jax_state("mixed", 1)
    assert np.array_equal(st.anchors, jx.anchors)
    assert np.array_equal(st.cands, jx.cands)


def test_no_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.compress_long_sharded(b"x" * 1000)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tl.ShardedLdmState(np.zeros(1000, np.uint8), 20)


# ---- host copies on the path --------------------------------------------------

def _cparams(level: int, n: int):
    j = jparams.get_cparams(level, n)
    t = tparams.get_cparams(level, n)
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    return j, t


PARSE_CASES = [
    # (data, window_low, block_start, block_end) of blocks and LDM gaps
    ("long", 0, 0, BS), ("long", 0, BS, 2 * BS),
    ("long", 1_048_000, 1_049_000, 1_049_700),
    ("long", 0, 3 * BS + 17, 3 * BS + 4_000),
    ("mixed", 0, 700_000, 700_000 + BS), ("mixed", 300_000, 1_000_000,
                                          1_020_000),
    ("mixed", 0, 5, 20), ("mixed", 0, 100, 115),
]


@pytest.mark.parametrize("case", range(len(PARSE_CASES)))
@pytest.mark.parametrize("level", LEVELS)
def test_fast_parse_equals_native(case, level):
    name, wl, bs, be = PARSE_CASES[case]
    full = _u8(LONG if name == "long" else MIXED)
    cj, ct = _cparams(level, len(full))
    from zstd_tpu.format import opt as jopt
    want = jopt.find_sequences_fast(full, bs, be, wl, (1, 4, 8), cj)
    got = topt.find_sequences_fast(full, bs, be, wl, (1, 4, 8), ct)
    assert want is not None
    assert got[1] == want[1]
    for f in ("lit_length", "off_base", "ml_base", "literals"):
        assert np.array_equal(np.asarray(getattr(got[0], f)),
                              np.asarray(getattr(want[0], f))), f


def test_split_points_equals_native():
    nat = get_native()
    full = _u8(MIXED[:1_000_000] + LONG[:1_000_000])
    seen = 0
    for bs in range(0, len(full) - BS, 40_000):
        want = nat.split_points(full, bs, bs + BS, 4096, 16384)
        assert tframe._split_points(full, bs, bs + BS) == want
        seen += bool(want)
    assert seen


def test_pack_fields_equals_bitwriter():
    rng = np.random.default_rng(9)
    nb = rng.integers(0, 32, 3000)
    vals = rng.integers(0, 1 << 40, 3000)
    bw = tbits.BitWriter()
    for v, b in zip(vals.tolist(), nb.tolist()):
        bw.add(v, b)
    assert tbits.pack_fields(vals, nb) == bw.close()
    assert tbits.pack_fields([], []) == tbits.BitWriter().close()


def _lit_blocks():
    rng = np.random.default_rng(4)
    return [
        _u8(gen_text(40_000, seed=2)).tobytes(),
        _u8(gen_text(900, seed=5)).tobytes(),            # 1X/4X both tried
        rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),   # raw
        b"a" * 3000,                                       # RLE
        bytes(rng.integers(97, 101, 20_000, dtype=np.uint8)),
        _u8(gen_text(700, seed=6)).tobytes(),            # repeat table
        b"xyz" * 10,                                       # below minimum
        bytes(rng.integers(0, 200, 120_000, dtype=np.uint8) // 3),
    ]


@pytest.mark.parametrize("strategy", (1, 4))
def test_compress_literals_equals_c(strategy):
    """A chain of literal blocks, each carrying the entropy state on."""
    js, ts = jlit.HufEntropyState(), tlit.HufEntropyState()
    for lit in _lit_blocks():
        jb, js = jlit.compress_literals(lit, js, strategy, False, False)
        tb, ts = tlit.compress_literals(lit, ts, strategy, False, False)
        assert tb == jb
        assert ts.repeat == js.repeat
        assert (ts.ctable is None) == (js.ctable is None)
        if js.ctable is not None:
            assert np.array_equal(ts.ctable.nb_bits, js.ctable.nb_bits)


def test_huf_encode_equals_c():
    for lit in _lit_blocks()[:3] + _lit_blocks()[4:]:
        arr = np.frombuffer(lit, np.uint8)
        count = np.bincount(arr, minlength=256).astype(np.int64)
        mx = int(arr.max())
        if count.max() == len(arr):
            continue
        ct = jhuf.build_huf_ctable(count, mx, 11)
        tct = thuf.build_huf_ctable(count, mx, 11)
        assert thuf.huf_encode_1x(lit, tct) == jhuf.huf_encode_1x(lit, ct)
        assert thuf.huf_encode_4x(lit, tct) == jhuf.huf_encode_4x(lit, ct)
        assert thuf.write_tree_description(tct) == \
            jhuf.build_huf_ctable_with_tree(count, mx, 11)[1]


def _ldm_blocks(level: int):
    """(full, cparams pair, window_log) and the port's and JAX's host LDM
    states over LONG's first 1.5 MiB."""
    full = _u8(LONG[:3 * 512 * 1024])
    cj, ct = _cparams(level, len(full))
    wlog = max(cj.window_log, 21)
    cj = dataclasses.replace(cj, window_log=wlog)
    ct = dataclasses.replace(ct, window_log=wlog)
    return full, cj, ct, jldm.LdmState(full, wlog), tldm.LdmState(full, wlog)


@pytest.mark.parametrize("level", LEVELS)
def test_write_sequences_section_equals_c(level):
    full, cj, ct, jst, tst = _ldm_blocks(level)
    jfse, tfse = jseq.FseEntropyState(), tseq.FseEntropyState()
    reps = (1, 4, 8)
    for b0 in range(0, len(full), BS):
        b1 = min(b0 + BS, len(full))
        seqs, nreps = jldm.find_sequences_ldm(full, b0, b1, 0, reps, cj, jst)
        tseqs, treps = tldm.find_sequences_ldm(full, b0, b1, 0, reps, ct, tst)
        assert treps == nreps
        assert np.array_equal(tseqs.off_base, seqs.off_base)
        assert tseqs.literals == seqs.literals
        jb, jfse = jseq.write_sequences_section(seqs, jfse, cj.strategy)
        tb, tfse = tseq.write_sequences_section(tseqs, tfse, ct.strategy)
        assert tb == jb
        assert (tfse.ll_repeat, tfse.of_repeat, tfse.ml_repeat) == \
            (jfse.ll_repeat, jfse.of_repeat, jfse.ml_repeat)
        reps = nreps


@pytest.mark.parametrize("level", LEVELS + (3, 9))
def test_compress_block_equals_c(level):
    full, cj, ct, jst, tst = _ldm_blocks(level)
    js, ts = jblock.BlockCState(), tblock.BlockCState()
    types = set()
    for b0 in range(0, len(full), BS):
        b1 = min(b0 + BS, len(full))
        jp, jt, js = jblock.compress_block(full, b0, b1, 0, js, cj,
                                           ldm_ctx=jst)
        tp, tt, ts = tblock.compress_block(full, b0, b1, 0, ts, ct, tst)
        assert (tp, tt, ts.reps) == (jp, jt, js.reps)
        types.add(tt)
    assert 2 in types
    # and the whole host frame, through both packages' host LdmState
    jf = jframe.compress_frame(full.tobytes(), cj, long_mode=True)
    tf = tframe.compress_frame(full.tobytes(), ct, checksum=False,
                               ldm_state=tldm.LdmState(full, ct.window_log))
    assert tf == jf
