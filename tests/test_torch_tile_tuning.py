"""The port's tile autotune cache (fastertransformer4codefuse_tpu_torch/ops/
tile_tuning.py) against the JAX package's (ops/tile_tuning.py): the JAX
tests' five cases (tests/test_tile_tuning.py) on the port's module and its
shipped cache, one key format for both modules, and the port's own rules:
an empty cache launches the default plans (the K ranges of ``split_ranges``
and the 128 x 128 GEMM with a group-M raster of 8 and up to 8 stages), an
entry of another card's SM count is a miss, an entry the kernels have no
instance for raises, naming it, and the CPU path never reads the cache.

On the CPU a launch is seen through a stand-in for the kernel library, which
records each C entry's arguments instead of launching."""
import json
import math
import os

import pytest
import torch

from fastertransformer4codefuse_tpu.ops import tile_tuning as jax_tt
from fastertransformer4codefuse_tpu_torch.ops import _cuda, quant_matmul as qm
from fastertransformer4codefuse_tpu_torch.ops import quant_matmul_fused as qmf
from fastertransformer4codefuse_tpu_torch.ops import quant_matmul_w4 as qm4
from fastertransformer4codefuse_tpu_torch.ops import tile_autotune as ta
from fastertransformer4codefuse_tpu_torch.ops import tile_tuning as tt

MODULES = {"port": tt, "jax": jax_tt}
SMS = 132


@pytest.fixture
def cache_file(tmp_path, monkeypatch):
    path = str(tmp_path / "tile_cache.json")
    monkeypatch.setenv("FTCF_TILE_CACHE", path)
    monkeypatch.delenv("FTCF_TILE_TUNE", raising=False)
    tt.invalidate()
    jax_tt.invalidate()
    yield path
    tt.invalidate()
    jax_tt.invalidate()


# --- the JAX tests' cases on both modules ------------------------------------


@pytest.mark.parametrize("mod", MODULES)
def test_record_lookup_roundtrip(cache_file, mod):
    m = MODULES[mod]
    assert m.lookup("stacked_w4", 16, 5120, 20480) is None
    m.record("stacked_w4", 16, 5120, 20480, 0, bn=2560, bk=2560, us=75.7)
    assert m.lookup("stacked_w4", 16, 5120, 20480) == (2560, 2560)
    # distinct keys: bm bucket, group, kernel
    assert m.lookup("stacked_w4", 256, 5120, 20480) is None
    assert m.lookup("stacked_w4", 16, 5120, 20480, G=128) is None
    assert m.lookup("stacked_w4g", 16, 5120, 20480) is None
    with open(cache_file) as f:
        data = json.load(f)
    [(k, v)] = data.items()
    assert "stacked_w4" in k and v["us"] == 75.7


@pytest.mark.parametrize("mod", MODULES)
def test_extra_fields_for_mega_kernel(cache_file, mod):
    m = MODULES[mod]
    m.record("fused_upd8", 16, 5120, 20480, 0, us=300.0,
             extra={"bku": 256, "bkp": 640, "bkd": 512})
    e = m.lookup_entry("fused_upd8", 16, 5120, 20480)
    assert (e["bku"], e["bkp"], e["bkd"]) == (256, 640, 512)


@pytest.mark.parametrize("mod", MODULES)
def test_env_kill_switch(cache_file, monkeypatch, mod):
    m = MODULES[mod]
    m.record("stacked_w4", 16, 5120, 20480, 0, bn=2560, bk=2560, us=75.7)
    monkeypatch.setenv("FTCF_TILE_TUNE", "0")
    assert m.lookup("stacked_w4", 16, 5120, 20480) is None
    monkeypatch.delenv("FTCF_TILE_TUNE")
    assert m.lookup("stacked_w4", 16, 5120, 20480) == (2560, 2560)


def _shipped():
    path = os.path.join(os.path.dirname(tt.__file__), "tile_cache.json")
    with open(path) as f:
        return json.load(f)


def test_shipped_cache_is_valid_json():
    """The port's committed tile_cache.json parses, and every entry is a plan
    the kernels have: a GEMM tile of GEMM_TILES with the 64-deep k tile, a
    group-M width and a stage cap of 2-8, or a GEMV split count a segment
    (each a count of ranges the GEMV takes); each recorded on a card named
    with its power limit and SM count, no slower than the default."""
    data = _shipped()
    assert data, "shipped cache should not be empty"
    for key, e in data.items():
        kernel, bm, k, n, g = key.split("|")
        K, N, G = int(k[1:]), int(n[1:]), int(g[1:])
        assert tt._key(kernel, int(bm[2:]), K, N, G) == key
        assert 0 < e["us"] <= e["default_us"], (key, e)
        assert e["card"] and e["power_limit"].endswith("W") and e["sms"] > 0, (key, e)
        assert int(bm[2:]) == tt.bucket(int(bm[2:])), key
        if "gemm" in kernel:
            assert (e["rows"], e["bn"]) in qm.GEMM_TILES and e["bk"] == qm.GEMM_BK, (key, e)
            assert e["group_m"] >= 1 and 2 <= e["stages"] <= qm.GEMM_MAX_STAGES, (key, e)
        else:
            assert kernel.split("_")[-2] == "gemv" and len(e["splits"]) in (1, 2), (key, e)
            assert e["bn"] == 0 and e["bk"] == 0, (key, e)
            for n_split in e["splits"]:
                assert n_split >= 1, (key, e)


def _codefuse_keys():
    """(kernel, bm, K, N, G) of CodeFuse-13B's served products: int8, int4 and
    int4 g128 at tp = 1 and 2; decode buckets 1, 4, 8 and 32 (K13, K3),
    GEMM buckets 512, 1024 and 4096 (K13, proj, down)."""
    H, F, Q = 5120, 20480, 15360
    for tp in (1, 2):
        for fmt, G in (("i8", 0), ("i4", 0), ("i4g", 128)):
            for bm in (1, 4, 8, 32):
                yield f"ncat_gemv_{fmt}", bm, H, (Q + F) // tp, G
                yield f"pd_gemv_{fmt}", bm, (H + F) // tp, H, G
            for bm in (512, 1024, 4096):
                yield f"ncat_gemm_{fmt}", bm, H, (Q + F) // tp, G
                yield f"gemm_{fmt}", bm, H // tp, H, G
                yield f"gemm_{fmt}", bm, F // tp, H, G


def _other_keys():
    """StarCoder-15B int8 (6144 -> 6400 / 6144 / 24576, 24576 -> 6144) and
    Mixtral-8x7B's int8 attention (4096 -> 6144 / 4096)."""
    shapes = [(6144, 6400), (6144, 6144), (6144, 24576), (24576, 6144), (4096, 6144),
              (4096, 4096)]
    for K, N in shapes:
        for bm in (1, 4, 8, 32):
            yield "gemv_i8", bm, K, N, 0
        for bm in (512, 1024, 4096):
            yield "gemm_i8", bm, K, N, 0


@pytest.mark.parametrize("which", ["codefuse13b", "starcoder15b+mixtral8x7b"])
def test_shipped_cache_covers_the_served_shapes(which):
    """Coverage pin: the shipped cache holds an entry, on the SM count it was
    recorded on, for every served shape named in ``_codefuse_keys`` /
    ``_other_keys``, so that a cache regression fails loudly instead of
    silently launching the defaults."""
    data = _shipped()
    keys = list(_codefuse_keys() if which == "codefuse13b" else _other_keys())
    missing = [tt._key(*k) for k in keys if tt._key(*k) not in data]
    assert not missing, missing
    sms = {data[tt._key(*k)]["sms"] for k in keys}
    assert len(sms) == 1
    [n_sms] = sms
    for k in keys:
        assert tt.lookup_entry(*k, sms=n_sms)


def test_the_sweep_covers_what_the_cache_must_hold():
    """Every key the coverage pin names is one the sweep's default cases
    record (``ops.tile_autotune.cases`` and buckets)."""
    swept = set()
    for c in ta.cases(list(ta.MODELS)):
        K, N = c.key_kn()
        for b in (1, *ta.GEMV_JOINT):
            swept.add(tt._key(c.kernel(True), b, K, N, c.G))
        for b in (64,) if c.op == "k8" else (512, 1024, 4096) if c.gemm() else ():
            swept.add(tt._key(c.kernel(False), b, K, N, c.G))
    need = {tt._key(*k) for k in [*_codefuse_keys(), *_other_keys()]}
    assert need <= swept, sorted(need - swept)


# --- one key format ------------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_what_one_module_records_the_other_looks_up(cache_file, writer, reader):
    w, r = MODULES[writer], MODULES[reader]
    w.record("ncat_gemm_i8", 1024, 5120, 35840, 0, bn=256, bk=64, us=700.5,
             extra={"rows": 128, "group_m": 8, "stages": 8, "sms": SMS})
    w.record("stacked_w4g", 16, 5120, 5120, 128, bn=1024, bk=2560, us=23.9)
    r.invalidate()
    assert r.lookup("ncat_gemm_i8", 1024, 5120, 35840) == (256, 64)
    assert r.lookup_entry("ncat_gemm_i8", 1024, 5120, 35840)["rows"] == 128
    assert r.lookup("stacked_w4g", 16, 5120, 5120, 128) == (1024, 2560)
    with open(cache_file) as f:
        assert sorted(json.load(f)) == ["ncat_gemm_i8|bm1024|k5120|n35840|g0",
                                        "stacked_w4g|bm16|k5120|n5120|g128"]


@pytest.mark.parametrize("M,b", [(1, 1), (2, 2), (3, 4), (8, 8), (9, 16), (32, 32), (33, 64),
                                 (130, 256), (1000, 1024), (1024, 1024), (3072, 4096),
                                 (4097, 4096), (20000, 4096)])
def test_m_buckets(M, b):
    assert tt.bucket(M) == b


# --- the port's launch plans -----------------------------------------------------


class _Lib:
    """Stands in for the kernel library: records each C entry's arguments."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ftcf_"):
            raise AttributeError(name)
        return lambda *a: self.calls.append((name, a)) or 0


@pytest.fixture
def lib(monkeypatch, cache_file):
    fake = _Lib()
    monkeypatch.setattr(_cuda, "lib", lambda: fake)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(qm, "_sm_count", lambda index: SMS)
    tt.hits.clear()
    tt.misses.clear()
    return fake


def _seed_split_ranges(K, N, sms, share=1.0, bits=8, group_size=0):
    """The K ranges the GEMV launched before the tile cache (the rule as it
    stood, kept here to pin the defaults)."""
    rows = K // 2 if bits == 4 else K
    max_rows = 512 if bits == 4 else 1024
    tiles = -(-N // 128)
    splits = max(-(-rows // max_rows), math.ceil(4 * sms * share / tiles))
    splits = max(1, min(splits, -(-rows // 32)))
    unit = math.lcm(8, group_size) if group_size else 8
    units = K // unit
    per = -(-units // min(splits, units))
    return -(-units // per), unit * per


def _operands(M, K, N, bits, G, fill=False):
    """x, w, scales of a launch; filled with random values where the plain
    versions compute (``fill``), else left as allocated (the stand-in
    library reads only their pointers)."""
    make = (lambda *a, **k: torch.randn(*a).to(k["dtype"])) if fill else torch.empty
    x = make(M, K, dtype=torch.bfloat16)
    w = (torch.randint(-128, 128, (K // 2 if bits == 4 else K, N), dtype=torch.int8) if fill
         else torch.empty(K // 2 if bits == 4 else K, N, dtype=torch.int8))
    sdt = torch.float32 if bits == 8 or not G else torch.bfloat16
    s = (make(K // G, N, dtype=sdt) if G else make(N, dtype=torch.float32))
    if fill:
        s = s.abs() * 0.01
    return x, w, s


SHAPES = [(5120, 15360, 0), (20480, 5120, 0), (1152, 384, 128), (2568, 272, 0), (10240, 5120, 0)]


@pytest.mark.parametrize("M", [1, 4, 32, 33, 1024])
@pytest.mark.parametrize("K,N,G", SHAPES)
@pytest.mark.parametrize("bits", [8, 4])
def test_an_empty_cache_launches_the_defaults(lib, M, K, N, G, bits):
    """K1 / K6 / K7 and K13 launch today's arguments when the cache holds
    nothing: the seed's split rule for the GEMV, 128 x 128 blocks in groups
    of 8 rows with up to 8 stages for the GEMM; each resolution a miss."""
    x, w, s = _operands(M, K, N, bits, G)
    y = torch.empty(M, N, dtype=torch.bfloat16)
    single = M <= qm.GEMV_MAX_M or bits == 4  # K1's GEMM entry is inline: gemm_plan below
    if bits == 8 and single:
        qm.launch_gemv(x, w, s, None, None, y, G)
    elif single:
        qm4.launch_w4(x, w, s, G, None, None, y, "k")
    x2, w2, s2 = _operands(M, K, 2 * N, bits, G)
    qmf._launch_ncat([(x, w, s, None, None), (x2, w2, s2, None, "gelu")], bits, G, "k13")
    *first, (name2, a2) = lib.calls
    if M <= qm.GEMV_MAX_M:
        split1 = _seed_split_ranges(K, N, SMS, 1.0, bits, G)
        split2 = _seed_split_ranges(K, 2 * N, SMS, 1.0, bits, G)
        at = 8 if bits == 8 else 9  # splits, chunk in the single GEMV's arguments
        assert first[0][1][at:at + 2] == split1, first[0][0]
        assert (a2[8:10], a2[19:21]) == (split1, split2), name2
    else:
        for name, a in [*first, (name2, a2)]:
            assert a[-5:-1] == (128, 128, 8, 8), name
    assert sum(tt.misses.values()) == len(lib.calls) and not tt.hits


@pytest.mark.parametrize("K1,K2,N,bits,G", [(5120, 20480, 5120, 8, 0), (2560, 10240, 5120, 4, 0),
                                            (5120, 20480, 5120, 4, 128)])
def test_k3_and_k1_gemm_defaults(lib, K1, K2, N, bits, G):
    """K3's two segments (joined over K, shares K1 / (K1 + K2)) and K1's GEMM:
    the seed's ranges and the default plan on a miss."""
    dev = torch.device("cpu")
    share = K1 / (K1 + K2)
    got = qm.gemv_splits(f"pd_gemv_{'i8' if bits == 8 else 'i4g' if G else 'i4'}", 4,
                         [(K1, N, share), (K2, N, 1 - share)], dev, bits, G)
    assert got == [_seed_split_ranges(K1, N, SMS, share, bits, G),
                   _seed_split_ranges(K2, N, SMS, 1 - share, bits, G)]
    assert qm.gemm_plan("gemm_i8", 3072, K1, N, 0, dev) == qm.DEFAULT_GEMM
    assert qm.DEFAULT_GEMM.args() == (128, 128, 8, 8)
    assert qm.gemm_tiles(3072, 15360, 20480) == 24 * 280


def _sms_entry(**fields):
    return {"bn": 0, "bk": 0, "us": 1.0, "note": "", "sms": SMS, **fields}


def test_entries_reach_the_launches(lib, cache_file):
    """A hit launches the entry's plan: K1's GEMV splits, K13's two segments'
    splits (keyed by N1 + N2) and K13's / K6's GEMM plans, each counted."""
    entries = {
        tt._key("gemv_i8", 4, 5120, 15360, 0): _sms_entry(splits=[3]),
        tt._key("ncat_gemv_i8", 32, 5120, 15360 + 30720, 0): _sms_entry(splits=[2, 7]),
        tt._key("ncat_gemm_i8", 1024, 5120, 15360 + 30720, 0): _sms_entry(
            bn=256, bk=64, rows=128, group_m=16, stages=4),
        tt._key("gemm_i4", 64, 5120, 15360, 0): _sms_entry(
            bn=128, bk=64, rows=64, group_m=4, stages=8),
    }
    with open(cache_file, "w") as f:
        json.dump(entries, f)
    tt.invalidate()
    x, w, s = _operands(4, 5120, 15360, 8, 0)
    qm.launch_gemv(x, w, s, None, None, torch.empty(4, 15360, dtype=torch.bfloat16))
    assert lib.calls[-1][1][8:10] == qm.split_chunk(5120, 3)
    for M, want in ((32, None), (1024, (128, 256, 16, 4))):
        x, w, s = _operands(M, 5120, 15360, 8, 0)
        x2, w2, s2 = _operands(M, 5120, 30720, 8, 0)
        qmf._launch_ncat([(x, w, s, None, None), (x2, w2, s2, None, "gelu")], 8, 0, "k13")
        a = lib.calls[-1][1]
        if want is None:
            assert (a[8:10], a[19:21]) == (qm.split_chunk(5120, 2), qm.split_chunk(5120, 7))
        else:
            assert a[-5:-1] == want
    x, w, s = _operands(64, 5120, 15360, 4, 0)
    qm4.launch_w4(x, w, s, 0, None, None, torch.empty(64, 15360, dtype=torch.bfloat16), "k6")
    assert lib.calls[-1][1][-5:-1] == (64, 128, 4, 8)
    assert dict(tt.hits) == {"gemv_i8": 1, "ncat_gemv_i8": 1, "ncat_gemm_i8": 1, "gemm_i4": 1}


def test_another_cards_entry_is_a_miss(lib, cache_file):
    """An entry recorded on a card of another SM count, or with none, is a
    miss: the defaults launch."""
    with open(cache_file, "w") as f:
        json.dump({tt._key("gemm_i8", 512, 5120, 5120, 0): _sms_entry(sms=114, bn=256, bk=64, rows=128, group_m=4, stages=4),
                   tt._key("gemv_i8", 1, 5120, 5120, 0): {"bn": 0, "bk": 0, "us": 1.0,
                                                          "splits": [2]}}, f)
    tt.invalidate()
    dev = torch.device("cpu")
    assert qm.gemm_plan("gemm_i8", 500, 5120, 5120, 0, dev) == qm.DEFAULT_GEMM
    assert qm.gemv_splits("gemv_i8", 1, [(5120, 5120, 1.0)], dev, 8) == [
        _seed_split_ranges(5120, 5120, SMS)]
    assert tt.misses == {"gemm_i8": 1, "gemv_i8": 1} and not tt.hits
    # the raw lookups still see both, as the JAX module would
    assert tt.lookup("gemm_i8", 512, 5120, 5120) == (256, 64)
    assert tt.lookup_entry("gemv_i8", 1, 5120, 5120)["splits"] == [2]


@pytest.mark.parametrize("fields", [
    dict(bn=128, bk=64, rows=96, group_m=8, stages=8),
    dict(bn=512, bk=64, rows=128, group_m=8, stages=8),
    dict(bn=128, bk=128, rows=128, group_m=8, stages=8),
    dict(bn=128, bk=64, rows=128, group_m=0, stages=8),
    dict(bn=128, bk=64, rows=128, group_m=8, stages=9),
    dict(bn=128, bk=64, rows=128, group_m=8),
])
def test_a_gemm_entry_the_kernel_cannot_serve_raises(lib, cache_file, fields):
    key = tt._key("gemm_i8", 1024, 5120, 5120, 0)
    with open(cache_file, "w") as f:
        json.dump({key: _sms_entry(**fields)}, f)
    tt.invalidate()
    with pytest.raises(ValueError, match=key.replace("|", r"\|")):
        qm.gemm_plan("gemm_i8", 1000, 5120, 5120, 0, torch.device("cpu"))


@pytest.mark.parametrize("splits", [[0], [641], [1], [2, 2], [2.0], "3", None])
def test_a_gemv_entry_the_kernel_cannot_serve_raises(lib, cache_file, splits):
    """Splits the GEMV has no ranges for (none, more than the 8-row units,
    ranges over GEMV_MAX_CHUNK rows, a count a segment missing) raise."""
    key = tt._key("gemv_i8", 8, 5120, 5120, 0)
    with open(cache_file, "w") as f:
        json.dump({key: _sms_entry(splits=splits)}, f)
    tt.invalidate()
    with pytest.raises(ValueError, match=key.replace("|", r"\|")):
        qm.gemv_splits("gemv_i8", 8, [(5120, 5120, 1.0)], torch.device("cpu"), 8)


def test_the_kill_switch_launches_the_defaults(lib, cache_file, monkeypatch):
    key = tt._key("gemm_i8", 1024, 5120, 5120, 0)
    with open(cache_file, "w") as f:
        json.dump({key: _sms_entry(bn=256, bk=64, rows=128, group_m=4, stages=4)}, f)
    tt.invalidate()
    dev = torch.device("cpu")
    assert qm.gemm_plan("gemm_i8", 1000, 5120, 5120, 0, dev).cols == 256
    monkeypatch.setenv("FTCF_TILE_TUNE", "0")
    assert qm.gemm_plan("gemm_i8", 1000, 5120, 5120, 0, dev) == qm.DEFAULT_GEMM


@pytest.mark.parametrize("M", [1, 8, 40])
def test_the_cpu_path_ignores_the_cache(cache_file, M):
    """CPU tensors take the plain versions and never read the cache: an
    entry that would raise on the card changes nothing here."""
    bad = _sms_entry(bn=999, bk=1, rows=3, group_m=0, stages=0, splits=[0, 0, 0])
    K, N = 256, 384
    with open(cache_file, "w") as f:
        json.dump({tt._key(k, tt.bucket(M), K, n, 0): bad for k, n in
                   (("gemv_i8", N), ("gemm_i8", N), ("gemv_i4", N), ("gemm_i4", N),
                    ("ncat_gemv_i8", 2 * N), ("ncat_gemm_i8", 2 * N),
                    ("pd_gemv_i8", N))}, f)
    tt.invalidate()
    tt.hits.clear()
    tt.misses.clear()
    x, w, s = _operands(M, K, N, 8, 0, fill=True)
    assert torch.equal(qm.quant_matmul(x, w, s), qm.quant_matmul_plain(x, w, s))
    _, p, s4 = _operands(M, K, N, 4, 0, fill=True)
    assert torch.equal(qm4.quant_matmul_w4(x, p, s4), qm4.quant_matmul_w4_plain(x, p, s4))
    y1, y2 = qmf.fused_qkv_up(x, x, w, w, s, s)
    assert torch.equal(y1, qm.quant_matmul_plain(x, w, s))
    if M <= qm.GEMV_MAX_M:
        h = torch.randn(M, K).to(torch.bfloat16)
        r = torch.zeros(M, N, dtype=torch.bfloat16)
        b = torch.zeros(N)
        qmf.fused_proj_down(x, h, w[:, :N], w, s, s, b, r)
    assert not tt.hits and not tt.misses


# --- the sweep's rules (ops/tile_autotune.py) ------------------------------------


def test_the_sweep_keeps_the_default_unless_a_candidate_wins_clearly():
    d, a, b = "default", "a", "b"
    # a wins by 10% at both widths, beyond the spread: taken
    assert ta.choose({d: [(100, 1), (200, 2)], a: [(90, 1), (180, 2)]}, d) == a
    # a wins overall but loses at one width: never taken
    assert ta.choose({d: [(100, 1), (200, 2)], a: [(101, 1), (100, 2)]}, d) == d
    # a gain under 3%, or under the windows' spread: the default stays
    assert ta.choose({d: [(100, 1)], a: [(98, 1)]}, d) == d
    assert ta.choose({d: [(100, 12)], a: [(90, 1)]}, d) == d
    # the best of several
    assert ta.choose({d: [(100, 1)], a: [(90, 1)], b: [(80, 1)]}, d) == b


@pytest.mark.parametrize("case", ta.cases(list(ta.MODELS)), ids=lambda c: c.note)
def test_every_sweep_candidate_is_a_plan_the_kernels_take(case):
    """The default first; every GEMV candidate a count of ranges the GEMV
    takes for each segment; every GEMM candidate an instance."""
    cands = ta.gemv_candidates(case, SMS)
    assert cands[0] == tuple(qm.split_ranges(K, N, SMS, sh, case.bits, case.G)[0]
                             for K, N, sh in case.segs())
    assert len(set(cands)) == len(cands) >= 2
    for cand in cands:
        for (K, _, _), n in zip(case.segs(), cand):
            splits, chunk = qm.split_chunk(K, n, case.G)
            assert splits == n and chunk <= qm.GEMV_MAX_CHUNK
    plans = ta.gemm_candidates()
    assert plans[0] == qm.DEFAULT_GEMM and len(set(plans)) == len(plans)
    assert {(p.rows, p.cols) for p in plans} == set(qm.GEMM_TILES)
