"""The port's native text parsers (io/textparse.py, csrc/textparse.cpp)
against the Python parsers they replace on the entries' path:
``DbFolder.names_and_norms`` and ``parse_query_hashes_file``. Names and
values must be equal bit for bit; input that the native pass does not take
exactly must go to the Python parser (counted as ``fallback``) and return
or raise just what it does. Then the process's slot of parsed norms: one
parse a db version, emptied by both caches' clear functions, and shards and
search hits equal to the JAX package's through it."""

import os
import shutil
import threading
from decimal import Decimal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from metagenome_vector_sketches_tpu.ann import search as jsearch  # noqa: E402
from metagenome_vector_sketches_tpu.matrix import compute as jmc  # noqa: E402
from metagenome_vector_sketches_tpu_torch.ann import search as tsearch  # noqa: E402
from metagenome_vector_sketches_tpu_torch.io import textparse  # noqa: E402
from metagenome_vector_sketches_tpu_torch.io.dbfolder import DbFolder  # noqa: E402
from metagenome_vector_sketches_tpu_torch.io.hashes import (  # noqa: E402
    parse_hashes_file, parse_query_hashes_file)
from metagenome_vector_sketches_tpu_torch.matrix import compute as tmc  # noqa: E402

U64_MAX = 2 ** 64 - 1
SHARD_FILES = ("matrix.bin", "row_index.bin", "neighbor_start.bin")


def _outcome(fn, *args):
    """-> ("ok", value) or ("raise", exception type, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as e:  # noqa: BLE001 - the type is compared
        return ("raise", type(e), str(e))


def _same_norms(got, want):
    assert got[0] == want[0]
    names, norms = got[1]
    wnames, wnorms = want[1]
    assert list(names) == list(wnames)
    assert all(type(n) is str for n in names)
    assert norms.dtype == np.float64 and norms.shape == wnorms.shape
    assert np.array_equal(norms.view(np.uint64), wnorms.view(np.uint64))


def _same_queries(got, want):
    assert got[0] == want[0]
    names, sets_ = got[1]
    wnames, wsets = want[1]
    assert names == wnames
    assert len(sets_) == len(wsets)
    for a, b in zip(sets_, wsets):
        assert a.dtype == np.uint64 and np.array_equal(a, b)


def _check(kind, path, expect_path):
    """Parse ``path`` both ways; the outcomes must be equal, and the call
    must count under ``expect_path``."""
    before = dict(textparse.PATHS)
    if kind == "norms":
        want = _outcome(lambda p: DbFolder(p).names_and_norms(), path)
        got = _outcome(textparse.parse_norms, path)
    else:
        want = _outcome(parse_query_hashes_file, path)
        got = _outcome(textparse.parse_queries, path)
    if want[0] == "raise":
        assert got == want
    elif kind == "norms":
        _same_norms(got, want)
    else:
        _same_queries(got, want)
    delta = {k: textparse.PATHS[k] - before[k] for k in before}
    if expect_path == "native" and textparse._library() is None:
        expect_path = "fallback"
    assert delta == {"native": int(expect_path == "native"),
                     "fallback": int(expect_path == "fallback")}
    return got


# -- vector_norms.txt ------------------------------------------------------

def _norms_text(rng, n, digits):
    x = rng.random(n) * 10.0 ** rng.integers(-7, 4, size=n)
    return "".join(f"S{i} {v:.{digits}g}\n" for i, v in enumerate(x))


def _halfway_text(rng, n):
    """Decimals that lie exactly halfway between two doubles, and their
    neighbours one unit of the 17th digit away: 17 significant digits,
    where only a correctly rounded conversion agrees with float()."""
    out = []
    for i in range(n):
        a = float(rng.random() * 10.0 ** rng.integers(-3, 4))
        b = np.nextafter(a, np.inf)
        mid = (Decimal(a) + Decimal(b)) / 2
        out.append(f"H{i} {mid:.17g}\n")
        out.append(f"G{i} {mid.next_plus():.17g}\n")
        out.append(f"L{i} {a!r}\n")
    return "".join(out)


NORMS_NATIVE = {
    "random-6-digits": lambda rng: _norms_text(rng, 3000, 6),
    "random-17-digits": lambda rng: _norms_text(rng, 3000, 17),
    "halfway-17-digits": lambda rng: _halfway_text(rng, 1000),
    "ragged-lines": lambda rng: (
        "\n\nA 1.5\nlonely\n  B   2.25  extra tokens here\n\t\n"
        "C\x0b3e-5\x1cmore\r\nD 7\rE -0\nF .5\nG 5.\nH +1.25E+2\n"
        "I 0.000000\nJ 123456789012345678901234567890\nK 1e22\nL 1e23\n"
        "M 9007199254740993\nN 0.1e-300\nlast 4.75"),
    "empty": lambda rng: "",
    "blank-only": lambda rng: "\n \n\t\n",
    # ~3 MB, as a db of 150,000 rows writes it
    "large-lf": lambda rng: _norms_text(rng, 150000, 6),
    "large-cr": lambda rng: _norms_text(rng, 150000, 6).replace("\n", "\r"),
}

NORMS_FALLBACK = {
    "inf": "A 1.0\nB inf\n",
    "nan": "A nan\n",
    "underscore": "A 1_000\n",
    "overflow": "A 1e999\n",
    "underflow": "A 1e-400\n",
    "subnormal": "A 4.9e-324\n",
    "not-a-number": "A 1.0\nB abc\n",
    "hex": "A 0x1p3\n",
    "non-ascii-name": "A\u00e9 1.0\n",
    "non-ascii-space": "A\u00a01.0 2.0\n",
    "nul": "A 1.0\x00\n",
    # ~3 MB of good lines, then one the native pass does not take
    "last-of-a-large-file": "".join(
        f"S{i} {i / 7:.6g}\n" for i in range(150000)) + "Z 1e999\n",
}


def _write(path, text, mode="w"):
    with open(path, mode, encoding="utf-8", newline="") as f:
        f.write(text)


def _norms_db(tmp_path, text):
    db = tmp_path / "db"
    db.mkdir(exist_ok=True)
    _write(db / "vector_norms.txt", text)
    return str(db)


NORMS_CASES = {
    **{f"native-{k}": ("native", k) for k in NORMS_NATIVE},
    **{f"fallback-{k}": ("fallback", k) for k in NORMS_FALLBACK},
    **{f"toy-{k}": ("toy", k) for k in ("toy_db_256", "toy_db_2048",
                                        "toy_db_2048_i16")},
    "fallback-missing-file": ("missing", None),
}


@pytest.mark.parametrize("case", sorted(NORMS_CASES))
def test_parse_norms_equals_names_and_norms(case, tmp_path, ref_toy_dir):
    kind, key = NORMS_CASES[case]
    rng = np.random.default_rng([7, len(case)])
    if kind == "native":
        _check("norms", _norms_db(tmp_path, NORMS_NATIVE[key](rng)),
               "native")
    elif kind == "fallback":
        _check("norms", _norms_db(tmp_path, NORMS_FALLBACK[key]),
               "fallback")
    elif kind == "toy":
        got = _check("norms", str(ref_toy_dir / key), "native")
        assert len(got[1][0]) == 61
    else:
        got = _check("norms", str(tmp_path / "nowhere"), "fallback")
        assert got[1] is FileNotFoundError


# -- query files -----------------------------------------------------------

def _queries_text(rng, lines, sizes, high=U64_MAX, end="\n"):
    out = []
    for i in range(lines):
        n = int(rng.integers(*sizes))
        h = rng.integers(0, high, size=n, dtype=np.uint64, endpoint=True)
        if n > 4:
            h[: n // 4] = h[n // 4: 2 * (n // 4)]  # repeats
        out.append(f"{' ' * (i % 3)}Q{i}{' ' * (i % 2)}: "
                   + " ".join(map(str, h)) + end)
    return "".join(out)


QUERIES_NATIVE = {
    "random-long-sets": lambda rng: _queries_text(rng, 12, (300, 5000)),
    "random-short-sets": lambda rng: _queries_text(rng, 40, (0, 255)),
    # keys that share their high bytes
    "small-values": lambda rng: _queries_text(rng, 6, (400, 3000), 70000),
    "edge-values": lambda rng: (
        f"max: {U64_MAX} 0 {U64_MAX} 18446744073709551614 000000000000000"
        f"00000000012 007 0\n"),
    "ragged-lines": lambda rng: (
        "\n   \n  padded name  :  3 1 2 2  \r\nempty:\n:\n\t:5\x0b6\x1f7\n"
        "tabbed\t:\t9\t8\n\nlast: 11 10"),
    "empty": lambda rng: "",
    "blank-only": lambda rng: "\n\r\n \t \n",
    "one-big-set": lambda rng: _queries_text(rng, 1, (300000, 300001)),
    # ~3 MB, 64 queries: the size of a search request's file
    "large-lf": lambda rng: _queries_text(rng, 64, (2000, 3000)),
    "large-cr": lambda rng: _queries_text(rng, 64, (2000, 3000), end="\r"),
    "large-crlf": lambda rng: _queries_text(rng, 64, (2000, 3000),
                                            end="\r\n"),
}

QUERIES_FALLBACK = {
    "two-colons": "a: 1 2\nb: 3: 4\n",
    "no-colon": "a: 1 2\nb 3 4\n",
    "overflow": f"a: {U64_MAX + 1}\n",
    "long-overflow": "a: 1234567890123456789012\n",
    "plus-sign": "a: +5 6\n",
    "minus-one": "a: -1\n",
    "underscore": "a: 1_000\n",
    "decimal": "a: 5.0\n",
    "hex": "a: 0x10\n",
    "non-ascii-digit": "a: \u0663\n",
    "non-ascii-name": "\u00e9: 1\n",
    "cr-splits-a-line": "a: 1\r2\n",
    # ~3 MB of good lines, then one the native pass does not take
    "last-of-a-large-file": "".join(
        f"Q{i}: " + " ".join(str(i * 7919 + k) for k in range(2500)) + "\n"
        for i in range(64)) + f"Z: 1 {U64_MAX + 1}\n",
}

QUERIES_CASES = {
    **{f"native-{k}": ("native", k) for k in QUERIES_NATIVE},
    **{f"fallback-{k}": ("fallback", k) for k in QUERIES_FALLBACK},
    "toy-all_hashes": ("toy", None),
    "fallback-missing-file": ("missing", None),
}


@pytest.mark.parametrize("case", sorted(QUERIES_CASES))
def test_parse_queries_equals_parse_query_hashes_file(case, tmp_path,
                                                      ref_toy_dir):
    kind, key = QUERIES_CASES[case]
    rng = np.random.default_rng([11, len(case)])
    path = str(tmp_path / "q.txt")
    if kind == "native":
        _write(path, QUERIES_NATIVE[key](rng))
        _check("queries", path, "native")
    elif kind == "fallback":
        _write(path, QUERIES_FALLBACK[key])
        _check("queries", path, "fallback")
    elif kind == "toy":
        got = _check("queries", str(ref_toy_dir / "all_hashes_toy.txt"),
                     "native")
        assert len(got[1][0]) == 61
    else:
        got = _check("queries", str(tmp_path / "nowhere.txt"), "fallback")
        assert got[1] is FileNotFoundError


# bytes that separate, end lines, or break a token, drawn at random into
# lines: whatever the native pass takes must equal the Python parsers
FUZZ_BYTES = [" ", "\t", "\x0b", "\x0c", "\x1c", "\x1f", "\n", "\r", ":",
              "+", "-", ".", "e", "E", "_", "0", "1", "9", "a", "\x00",
              "\u00a0", "12345", "18446744073709551616", "1e5", "0.25"]


@pytest.mark.parametrize("kind", ["norms", "queries"])
@pytest.mark.parametrize("seed", range(6))
def test_random_bytes_parse_as_the_python_parsers(kind, seed, tmp_path):
    rng = np.random.default_rng([seed, kind == "norms"])
    paths = []
    for i in range(40):
        # mostly well-formed lines with a stray byte or two, so both paths
        # run
        lines = []
        for j in range(int(rng.integers(0, 6))):
            if kind == "norms":
                line = f"N{j} {rng.random():.6g}"
            else:
                line = f"Q{j}: " + " ".join(
                    str(int(x)) for x in rng.integers(0, 1 << 62, size=5))
            if rng.random() < 0.3:
                at = int(rng.integers(0, len(line) + 1))
                line = (line[:at] + str(rng.choice(FUZZ_BYTES))
                        + line[at:])
            lines.append(line)
        text = "\n".join(lines) + ("\n" if rng.random() < 0.5 else "")
        if kind == "norms":
            (tmp_path / f"f{i}").mkdir()
            path = _norms_db(tmp_path / f"f{i}", text)
        else:
            path = str(tmp_path / f"q{i}.txt")
            _write(path, text)
        paths.append(path)
    native = 0
    for path in paths:
        before = textparse.PATHS["native"]
        if kind == "norms":
            want = _outcome(lambda p: DbFolder(p).names_and_norms(), path)
            got = _outcome(textparse.parse_norms, path)
        else:
            want = _outcome(parse_query_hashes_file, path)
            got = _outcome(textparse.parse_queries, path)
        if want[0] == "raise":
            assert got == want
        elif kind == "norms":
            _same_norms(got, want)
        else:
            _same_queries(got, want)
        native += textparse.PATHS["native"] - before
    if textparse._library() is not None:
        assert native > 0


@pytest.mark.parametrize("kind", ["norms", "queries"])
def test_the_native_pass_refuses_a_pipe(kind, tmp_path):
    """A pipe (as a shell's process substitution gives) has no size to read
    to: the native pass refuses it, so the Python parser reads it to its
    end."""
    fifo = str(tmp_path / ("vector_norms.txt" if kind == "norms"
                           else "q.txt"))
    os.mkfifo(fifo)
    # a writer that opens and closes once: the reader's open returns then
    th = threading.Thread(target=lambda: open(fifo, "w").close(),
                          daemon=True)
    th.start()
    native = (textparse._native_norms if kind == "norms"
              else textparse._native_queries)
    try:
        assert native(fifo) is None
    finally:
        th.join(timeout=10)
    assert not th.is_alive()


def test_library_builds():
    """The native library builds here: every other case would pass through
    the fallback alone if it did not."""
    assert textparse._library() is not None


@pytest.mark.parametrize("kind", ["norms", "queries"])
def test_without_a_compiler_every_call_falls_back(kind, tmp_path,
                                                  monkeypatch, ref_toy_dir):
    """No library builds (no C++ compiler, nothing built yet): the Python
    parsers answer every call, and what they return is unchanged."""
    monkeypatch.setattr(textparse, "_lib", None)
    monkeypatch.setattr(textparse, "_lib_failed", False)
    monkeypatch.setattr(textparse, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(textparse.shutil, "which", lambda name: None)
    path = (str(ref_toy_dir / "toy_db_256") if kind == "norms"
            else str(ref_toy_dir / "all_hashes_toy.txt"))
    _check(kind, path, "fallback")
    assert textparse._library() is None
    assert not (tmp_path / "build").exists()


# -- the slot of parsed norms ----------------------------------------------

@pytest.fixture
def counted(monkeypatch):
    """Counts the slot's parses of a norms file."""
    calls = []
    real = textparse._norms_or_fallback

    def spy(db_folder):
        calls.append(db_folder)
        return real(db_folder)

    monkeypatch.setattr(textparse, "_norms_or_fallback", spy)
    textparse.clear_norms()
    yield calls
    textparse.clear_norms()


@pytest.fixture(scope="module")
def toy_db(tmp_path_factory, ref_toy_dir):
    """toy_db_256 and a query file of 6 of its own accessions."""
    root = tmp_path_factory.mktemp("slot")
    db = root / "db"
    shutil.copytree(str(ref_toy_dir / "toy_db_256"), db)
    named = dict(parse_hashes_file(str(ref_toy_dir / "all_hashes_toy.txt")))
    names, _ = DbFolder(str(db)).names_and_norms()
    qf = root / "q.txt"
    with open(qf, "w") as f:
        for n in names[:30:5]:
            f.write(f"{n}: " + " ".join(str(h) for h in named[n]) + "\n")
    return str(db), str(qf)


def _search(db, qf):
    return tsearch.search_index(db, qf, 0.05, verbose=False, engine="int8",
                                device="cpu")


def test_second_search_does_not_parse_the_norms_again(toy_db, counted):
    db, qf = toy_db
    first = _search(db, qf)
    assert counted == [db]
    names, norms = textparse.db_names_and_norms(db)
    assert _search(db, qf) == first
    assert counted == [db]
    again = textparse.db_names_and_norms(db)
    assert again[0] is names and again[1] is norms
    assert isinstance(names, tuple) and not norms.flags.writeable
    with pytest.raises(ValueError):
        norms[0] = 1.0
    tsearch.clear_index_cache()


@pytest.mark.parametrize("change", ["mtime", "size", "clear_index_cache",
                                    "clear_device_cache"])
def test_slot_parses_again_after(change, tmp_path, ref_toy_dir, counted):
    db = str(tmp_path / "db")
    shutil.copytree(str(ref_toy_dir / "toy_db_256"), db)
    path = os.path.join(db, "vector_norms.txt")
    first = textparse.db_norms(db)
    assert textparse.db_norms(db) is first and len(counted) == 1
    if change == "mtime":
        st = os.stat(path)
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns + 10 ** 9))
    elif change == "size":
        st = os.stat(path)
        with open(path) as f:
            text = f.read()
        _write(path, text.replace(" ", "  ", 1))
        os.utime(path, ns=(st.st_atime_ns, st.st_mtime_ns))
        assert os.stat(path).st_size == st.st_size + 1
    elif change == "clear_index_cache":
        tsearch.clear_index_cache()
        assert textparse._SLOT is None
    else:
        tmc.clear_device_cache()
        assert textparse._SLOT is None
    second = textparse.db_norms(db)
    assert len(counted) == 2 and second is not first
    assert np.array_equal(second, first)


def test_query_files_are_parsed_every_call(tmp_path):
    path = str(tmp_path / "q.txt")
    _write(path, "a: 3 1 2\n")
    before = textparse.PATHS["native"] + textparse.PATHS["fallback"]
    assert textparse.parse_queries(path)[1][0].tolist() == [1, 2, 3]
    _write(path, "a: 5 4\n")
    assert textparse.parse_queries(path)[1][0].tolist() == [4, 5]
    assert (textparse.PATHS["native"] + textparse.PATHS["fallback"]
            - before) == 2


def test_search_through_the_slot_equals_jax(toy_db, counted):
    """Hits of a first call, which fills the slot, and of a second, which
    reads it, equal the JAX package's."""
    db, qf = toy_db
    want = jsearch.search_index(db, qf, 0.05, verbose=False, engine="int8")
    tsearch.clear_index_cache()
    assert len(want) >= 6
    for _ in range(2):
        got = _search(db, qf)
        assert {(q, n) for q, n, _ in got} == {(q, n) for q, n, _ in want}
        gw = {(q, n): x for q, n, x in want}
        for q, n, x in got:
            assert abs(x - gw[(q, n)]) <= 1e-12
    assert counted == [db]
    tsearch.clear_index_cache()


@pytest.mark.parametrize("engine", ["fused", "two_phase", "streaming"])
def test_shards_through_the_slot_equal_jax(engine, tmp_path, ref_toy_dir,
                                           counted):
    """Shards 0 and 1 of one process (the second reads the slot) are
    byte-equal to the JAX package's."""
    db = str(ref_toy_dir / "toy_db_2048")
    kw = {"device_budget_bytes": 0} if engine == "streaming" else {}
    for k in range(2):
        tmc.compute_pairwise_shard(
            db, str(tmp_path / "port"), num_shards=2, shard_idx=k,
            tile_rows=16, verbose=False, device="cpu",
            engine="fused" if engine == "streaming" else engine, **kw)
        jmc.compute_pairwise_shard(db, str(tmp_path / "jax"), num_shards=2,
                                   shard_idx=k, tile_rows=16, verbose=False)
        for f in SHARD_FILES:
            with open(tmp_path / "port" / f"shard_{k}" / f, "rb") as a, \
                    open(tmp_path / "jax" / f"shard_{k}" / f, "rb") as b:
                assert a.read() == b.read(), (k, f)
    assert counted == [db]
    tmc.clear_device_cache()
    jmc.clear_device_cache()
