"""The port's RData reader and the loaders' .rda and Voteview-CSV branches,
held against the JAX package's on the CPU.

A small XDR writer below produces what R's ``save()`` produces for the
objects the readers decode (R Internals, 'Serialization Formats'): the
flags word (type in the low byte, object bit 8, attribute bit 9, tag bit
10, the levels above), each symbol written once and then as a REFSXP back
reference, ``row.names`` in R's compact form c(NA_integer_, -n), factors
as INTSXP with ``levels`` and ``class``, and the v3 native-encoding
string. Both packages' ``load_rda`` read every stream to the same objects;
the bundled senate116 and SDO frames, written as .rda files and as
Voteview CSVs at full size, load to the bundled .npz arrays."""

import bz2
import csv
import gzip
import lzma
import os
import struct

import numpy as np
import pytest

import _torch_threads  # noqa: F401  (one torch thread a process)
from gpirt_tpu.utils import datasets as jd
from gpirt_tpu.utils import rdata as jr
from gpirt_tpu_torch.utils import datasets as td
from gpirt_tpu_torch.utils import rdata as tr

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
NA_INT = -2147483648
NILVALUE, SYM, LIST, CHAR, LGL, INT, REAL, STR, VEC, REF, ALTREP = (
    254, 1, 2, 9, 10, 13, 14, 16, 19, 255, 238)
ASCII, UTF8 = 64 << 12, 8 << 12  # CHARSXP levels: ASCII_MASK, UTF8_MASK


class Col:
    """A data.frame column: an atomic vector of R type ``typ`` (LGL, INT,
    REAL or STR), or a factor (INT codes with ``levels``), or an ALTREP
    compact_intseq (``seq=(n, start, step)``)."""

    def __init__(self, typ, values=None, levels=None, seq=None):
        self.typ, self.values, self.levels, self.seq = typ, values, levels, seq


class XDR:
    """R's XDR serializer for the subset the readers decode."""

    def __init__(self):
        self.out = bytearray()
        self.symbols = {}

    def i32(self, v):
        self.out += struct.pack(">i", v)

    def flags(self, typ, obj=False, attr=False, tag=False, levels=0):
        self.i32(typ | (obj << 8) | (attr << 9) | (tag << 10) | levels)

    def char(self, s):
        if s is None:
            self.flags(CHAR)
            self.i32(-1)  # NA_STRING
            return
        b = s.encode("utf-8")
        self.flags(CHAR, levels=ASCII if s.isascii() else UTF8)
        self.i32(len(b))
        self.out += b

    def symbol(self, name):
        if name in self.symbols:  # a back reference, its index in the flags
            self.i32((self.symbols[name] << 8) | REF)
            return
        self.flags(SYM)
        self.char(name)
        self.symbols[name] = len(self.symbols) + 1

    def strings(self, values, attrs=None):
        self.flags(STR, attr=bool(attrs))
        self.i32(len(values))
        for s in values:
            self.char(s)
        self.attributes(attrs)

    def ints(self, values, typ=INT, attrs=None, obj=False):
        a = np.asarray(values)
        self.flags(typ, obj=obj, attr=bool(attrs))
        self.i32(a.size)
        self.out += a.astype(">f8" if typ == REAL else ">i4").tobytes()
        self.attributes(attrs)

    def pairlist(self, items):
        """(tag, writer) pairs as a tagged pairlist ended by R_NilValue."""
        for tag, write in items:
            self.flags(LIST, tag=True)
            self.symbol(tag)
            write()
        self.flags(NILVALUE)

    def attributes(self, attrs):
        if attrs:
            self.pairlist(list(attrs.items()))

    def altrep_intseq(self, n, start, step, cls="compact_intseq"):
        self.flags(ALTREP)
        # info: an untagged pairlist (class symbol, package symbol, type)
        for write in (lambda: self.symbol(cls), lambda: self.symbol("base"),
                      lambda: self.ints([INT])):
            self.flags(LIST)
            write()
        self.flags(NILVALUE)
        self.ints([n, start, step], typ=REAL)  # state
        self.flags(NILVALUE)  # attributes

    def column(self, col):
        if col.seq is not None:
            self.altrep_intseq(*col.seq)
        elif col.levels is not None:
            self.ints(col.values, obj=True, attrs={
                "levels": lambda: self.strings(col.levels),
                "class": lambda: self.strings(["factor"])})
        elif col.typ == STR:
            self.strings(col.values)
        else:
            self.ints(col.values, typ=col.typ)

    def data_frame(self, columns, n):
        self.flags(VEC, obj=True, attr=True)
        self.i32(len(columns))
        for col in columns.values():
            self.column(col)
        self.attributes({
            "names": lambda: self.strings(list(columns)),
            "class": lambda: self.strings(["data.frame"]),
            "row.names": lambda: self.ints([NA_INT, -n])})


def rda_bytes(objects, version=3, compress="gzip"):
    """An .rda file's bytes: ``objects`` maps names to writers taking an
    XDR; written as R's ``save()`` writes them, then compressed."""
    w = XDR()
    w.out += f"RDX{version}\nX\n".encode()
    w.i32(version)
    w.i32(0x040301)  # writer: R 4.3.1
    w.i32(0x030500 if version == 3 else 0x020300)  # least reader version
    if version == 3:
        w.i32(5)
        w.out += b"UTF-8"
    w.pairlist([(name, (lambda f=f: f(w))) for name, f in objects.items()])
    raw = bytes(w.out)
    return {"gzip": gzip.compress, "bz2": bz2.compress, "xz": lzma.compress,
            "none": lambda b: b}[compress](raw)


def write_rda(path, objects, **kw):
    with open(path, "wb") as fh:
        fh.write(rda_bytes(objects, **kw))
    return str(path)


def plain(obj):
    """An RObject of either package as nested tuples of plain values."""
    if obj is None:
        return None
    if isinstance(obj, (jr.RObject, tr.RObject)):
        return ("RObject", obj.type, plain(obj.value),
                tuple(sorted((k, plain(v)) for k, v in obj.attributes.items())))
    if isinstance(obj, np.ndarray):
        return ("array", obj.dtype.str, obj.shape,
                tuple("NaN" if isinstance(v, float) and v != v else v
                      for v in obj.ravel().tolist()))
    if isinstance(obj, dict):
        return tuple((k, plain(v)) for k, v in obj.items())
    if isinstance(obj, (list, tuple)):
        return tuple(plain(v) for v in obj)
    return obj


def small_frame():
    """A data.frame with integer, real, logical and string columns, a
    factor, NA_integer_, NA and NA_character_, and a compact_intseq."""
    cols = {
        "id": Col(INT, seq=(5, 11, 2)),
        "count": Col(INT, [3, NA_INT, 0, -7, 2]),
        "score": Col(REAL, [0.5, -1.25, np.nan, 3.0, 1e300]),
        "flag": Col(LGL, [1, 0, NA_INT, 1, 0]),
        "label": Col(STR, ["a", "bé", None, "dd", ""]),
        "party": Col(INT, [2, 1, NA_INT, 2, 3], levels=["D", "I", "R"]),
    }
    return {"df": lambda w: w.data_frame(cols, 5),
            "x": lambda w: w.ints([1.5, 2.5], typ=REAL, attrs={
                "names": lambda: w.strings(["count", "id"])})}


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("compress", ["gzip", "bz2", "xz", "none"])
def test_both_readers_decode_the_same_objects(tmp_path, version, compress):
    path = write_rda(tmp_path / "small.rda", small_frame(), version=version,
                     compress=compress)
    got_j, got_t = jr.load_rda(path), tr.load_rda(path)
    assert list(got_t) == list(got_j) == ["df", "x"]
    assert plain(got_t) == plain(got_j)
    df = got_t["df"].to_python()
    assert plain(df) == plain(got_j["df"].to_python())
    assert list(df) == ["id", "count", "score", "flag", "label", "party"]
    np.testing.assert_array_equal(df["id"], [11, 13, 15, 17, 19])
    assert df["id"].dtype == np.int32
    np.testing.assert_array_equal(df["count"], [3, tr.R_NA_INT, 0, -7, 2])
    np.testing.assert_array_equal(df["score"], [0.5, -1.25, np.nan, 3.0, 1e300])
    np.testing.assert_array_equal(df["flag"], [1.0, 0.0, np.nan, 1.0, 0.0])
    assert list(df["label"]) == ["a", "bé", None, "dd", ""]
    assert list(df["party"]) == ["I", "D", None, "I", "R"]
    assert got_t["df"].attr("row.names").tolist() == [NA_INT, -5]
    assert got_t["x"].names.tolist() == ["count", "id"]


def test_a_repeated_symbol_is_a_back_reference(tmp_path):
    """'names' and 'class' are written once, then as REFSXP: the stream
    holds each symbol's CHARSXP once, and both readers resolve the rest."""
    raw = rda_bytes(small_frame(), compress="none")
    for name in (b"names", b"class", b"levels"):
        assert raw.count(struct.pack(">i", len(name)) + name) == 1
    path = write_rda(tmp_path / "refs.rda", small_frame(), compress="none")
    for reader in (jr, tr):
        objs = reader.load_rda(path)
        assert set(objs["df"].attributes) == {"names", "class", "row.names"}
        assert objs["df"].value[5].attr("class").tolist() == ["factor"]
        assert objs["x"].names.tolist() == ["count", "id"]


def test_not_rdata_is_a_value_error(tmp_path):
    path = tmp_path / "plain.rda"
    path.write_bytes(gzip.compress(b"not an R file at all"))
    for reader in (jr, tr):
        with pytest.raises(ValueError, match="not an RData file"):
            reader.load_rda(str(path))


def test_unknown_altrep_class_is_not_implemented(tmp_path):
    path = write_rda(tmp_path / "alt.rda", {
        "v": lambda w: w.altrep_intseq(3, 1, 1, cls="mystery_seq")})
    for reader in (jr, tr):
        with pytest.raises(NotImplementedError, match="mystery_seq"):
            reader.load_rda(path)


def _npz(name):
    with np.load(os.path.join(DATA, name)) as z:
        return {k: z[k] for k in z.files}


def _senate_frame(rows):
    """The senate116 data.frame R holds: congress and chamber constant,
    rollnumber and icpsr doubles (as read_csv gives them), cast_code
    integer."""
    n = rows["rollnumber"].size
    cols = {
        "congress": Col(REAL, np.full(n, 116.0)),
        "chamber": Col(INT, np.ones(n, np.int32), levels=["Senate"]),
        "rollnumber": Col(REAL, rows["rollnumber"].astype(np.float64)),
        "icpsr": Col(REAL, rows["icpsr"].astype(np.float64)),
        "cast_code": Col(INT, rows["cast_code"].astype(np.int32)),
    }
    return {"senate116": lambda w: w.data_frame(cols, n)}


def _sdo_frame(responses, names):
    codes = np.where(np.isnan(responses), NA_INT, responses).astype(np.int32)
    cols = {name: Col(INT, codes[:, j]) for j, name in enumerate(names)}
    return {"SDO": lambda w: w.data_frame(cols, responses.shape[0])}


def _point_both_at(monkeypatch, directory):
    for mod in (jd, td):
        for name in ("_LOCAL_DATA", "_REFERENCE_DATA", "_REFERENCE_RAW"):
            monkeypatch.setattr(mod, name, str(directory))


def _equal_frames(a, b):
    assert set(a) == set(b) == {"rollnumber", "icpsr", "cast_code"}
    for k in b:
        assert a[k].dtype == np.int64
        np.testing.assert_array_equal(a[k], b[k])


def test_rda_branches_load_the_bundled_data_at_full_size(tmp_path, monkeypatch):
    """senate116 (42,800 rows) and SDO (1500 x 16, NA_integer_ as NaN)
    written as gzipped .rda files: both packages' loaders return the
    bundled .npz arrays, and senate116_response_matrix is equal between
    the packages."""
    senate, sdo = _npz("senate116.npz"), _npz("SDO.npz")
    names = [str(s) for s in sdo["item_names"]]
    write_rda(tmp_path / "senate116.rda", _senate_frame(senate))
    write_rda(tmp_path / "SDO.rda", _sdo_frame(sdo["responses"], names))
    _point_both_at(monkeypatch, tmp_path)
    for mod in (jd, td):
        _equal_frames(mod.load_senate116(), senate)
        mat, got_names = mod.load_sdo(with_names=True)
        np.testing.assert_array_equal(mat, sdo["responses"])
        assert got_names == names and np.isnan(mat).any()
    rm_j, sen_j, roll_j = jd.senate116_response_matrix()
    rm_t, sen_t, roll_t = td.senate116_response_matrix()
    np.testing.assert_array_equal(np.asarray(rm_t), np.asarray(rm_j))
    np.testing.assert_array_equal(sen_t, sen_j)
    np.testing.assert_array_equal(roll_t, roll_j)
    assert np.asarray(rm_t).shape == (100, 418)


def test_csv_branch_rebuilds_senate116(tmp_path, monkeypatch):
    """The Voteview CSVs with three session-2 roll calls after the 428 of
    session 1: both packages keep session 1 only, equal to the .npz."""
    senate = _npz("senate116.npz")
    rolls = np.unique(senate["rollnumber"])
    extra = [429, 430, 431]
    with open(tmp_path / "S116_rollcalls.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["congress", "chamber", "rollnumber", "date", "session", "yea_count"])
        for rn in rolls:
            w.writerow([116, "Senate", rn, "2019-01-03", 1, 50])
        for rn in extra:
            w.writerow([116, "Senate", rn, "2020-01-06", 2, 48])
    senators = np.unique(senate["icpsr"])
    with open(tmp_path / "S116_votes.csv", "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["congress", "chamber", "rollnumber", "icpsr", "cast_code", "prob"])
        for rn, ic, cc in zip(senate["rollnumber"], senate["icpsr"], senate["cast_code"]):
            w.writerow([116, "Senate", rn, ic, cc, 99.5])
        for rn in extra:
            for ic in senators[:7]:
                w.writerow([116, "Senate", rn, ic, 1, 80.0])
    _point_both_at(monkeypatch, tmp_path)
    for mod in (jd, td):
        _equal_frames(mod.load_senate116(), senate)


@pytest.mark.parametrize("dataset", ["senate116", "SDO"])
def test_bundled_npz_is_read_before_an_explicit_rda_path(tmp_path, dataset):
    """Both packages read data/<name>.npz when it exists, even when an .rda
    path is given: a 3-row .rda passed explicitly is not what comes back."""
    if dataset == "senate116":
        few = {k: v[:3] for k, v in _npz("senate116.npz").items()}
        path = write_rda(tmp_path / "mine.rda", _senate_frame(few))
        for mod in (jd, td):
            assert mod.load_senate116(path)["icpsr"].size == 42800
    else:
        sdo = _npz("SDO.npz")
        path = write_rda(tmp_path / "mine.rda",
                         _sdo_frame(sdo["responses"][:3], list(sdo["item_names"])))
        for mod in (jd, td):
            assert mod.load_sdo(path).shape == (1500, 16)
    for mod in (jd, td):  # without the bundled archive the path is read
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(mod, "_LOCAL_DATA", str(tmp_path / "none"))
            mp.setattr(mod, "_REFERENCE_DATA", str(tmp_path / "none"))
            got = (mod.load_senate116(path)["icpsr"] if dataset == "senate116"
                   else mod.load_sdo(path))
            assert got.shape[0] == 3
