"""Minimal pure-Python reader for R serialization (.rda / .rds, XDR v2/v3).

The port's own copy of ``gpirt_tpu/utils/rdata.py`` (pure Python over
numpy), with the same names and behaviour: the port imports nothing of the
JAX package.

The reference ships its example datasets as lazy-loaded .rda files
(data/senate116.rda, data/SDO.rda). This module decodes the subset of R's
serialization format those files use — atomic vectors, pairlists, generic
vectors, attributes, factors, data.frames, matrices — without requiring an R
installation. Implemented from the publicly documented format
("R Internals", section 'Serialization Formats'); no reference code involved.
Compressed files (gzip, bzip2, xz) are decompressed first.
"""

from __future__ import annotations

import gzip
import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["load_rda", "RObject", "R_NA_INT"]

# SEXP type codes (R Internals)
NILSXP = 0
SYMSXP = 1
LISTSXP = 2
CLOSXP = 3
ENVSXP = 4
LANGSXP = 6
CHARSXP = 9
LGLSXP = 10
INTSXP = 13
REALSXP = 14
CPLXSXP = 15
STRSXP = 16
VECSXP = 19
RAWSXP = 24
# pseudo-types used by the serializer
REFSXP = 255
NILVALUE_SXP = 254
GLOBALENV_SXP = 253
UNBOUNDVALUE_SXP = 252
MISSINGARG_SXP = 251
BASENAMESPACE_SXP = 250
NAMESPACESXP = 249
PACKAGESXP = 248
PERSISTSXP = 247
EMPTYENV_SXP = 242
BASEENV_SXP = 241
ALTREP_SXP = 238

R_NA_INT = -2147483648


@dataclass
class RObject:
    """A decoded R object: data plus attributes."""

    type: int
    value: Any = None
    attributes: Dict[str, "RObject"] = field(default_factory=dict)

    def attr(self, name: str, default=None):
        a = self.attributes.get(name)
        return a.value if a is not None else default

    @property
    def names(self):
        return self.attr("names")

    def to_python(self):
        """Best-effort conversion to plain numpy / dict structures."""
        cls = self.attr("class")
        cls = list(np.atleast_1d(cls)) if cls is not None else []
        if "data.frame" in cls:
            names = self.names
            names = list(np.atleast_1d(names)) if names is not None else []
            return {
                n: _column_to_python(col) for n, col in zip(names, self.value)
            }
        if "factor" in cls:
            levels = np.atleast_1d(self.attr("levels"))
            codes = np.asarray(self.value)
            vals = np.empty(codes.shape, object)
            for i, c in enumerate(codes.ravel()):
                vals.ravel()[i] = None if c == R_NA_INT else levels[c - 1]
            return vals
        dim = self.attr("dim")
        if dim is not None and self.value is not None:
            arr = np.asarray(self.value)
            return arr.reshape(tuple(int(d) for d in np.atleast_1d(dim)), order="F")
        return self.value


def _column_to_python(col):
    if isinstance(col, RObject):
        return col.to_python()
    return col


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0
        self.refs: List[Any] = []

    def _take(self, n: int) -> bytes:
        b = self.data[self.pos : self.pos + n]
        if len(b) != n:
            raise EOFError("truncated RData stream")
        self.pos += n
        return b

    def u8(self) -> int:
        return self._take(1)[0]

    def i32(self) -> int:
        return struct.unpack(">i", self._take(4))[0]

    def f64(self) -> float:
        return struct.unpack(">d", self._take(8))[0]

    def i32s(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(4 * n), dtype=">i4").astype(np.int32)

    def f64s(self, n: int) -> np.ndarray:
        return np.frombuffer(self._take(8 * n), dtype=">f8").astype(np.float64)

    def length(self) -> int:
        n = self.i32()
        if n == -1:  # long vector: two more words
            hi = self.i32() & 0xFFFFFFFF
            lo = self.i32() & 0xFFFFFFFF
            return (hi << 32) | lo
        return n

    # -- object reading ----------------------------------------------------

    def read_object(self) -> Optional[RObject]:
        flags = self.i32()
        typ = flags & 0xFF
        has_attr = bool(flags & (1 << 9))
        has_tag = bool(flags & (1 << 10))

        if typ == NILVALUE_SXP or typ == NILSXP:
            return None
        if typ == REFSXP:
            idx = flags >> 8
            if idx == 0:
                idx = self.i32()
            return self.refs[idx - 1]
        if typ == SYMSXP:
            sym = self.read_object()  # CHARSXP
            obj = RObject(SYMSXP, sym.value if sym else None)
            self.refs.append(obj)
            return obj
        if typ in (PACKAGESXP, NAMESPACESXP, PERSISTSXP):
            # stringvec payload; record a ref slot
            n = self.i32()
            strs = [self.read_object() for _ in range(n)]
            obj = RObject(typ, [s.value for s in strs if s])
            self.refs.append(obj)
            return obj
        if typ in (GLOBALENV_SXP, BASEENV_SXP, EMPTYENV_SXP, UNBOUNDVALUE_SXP,
                   MISSINGARG_SXP, BASENAMESPACE_SXP):
            return RObject(typ, None)
        if typ == ENVSXP:
            # locked flag, enclos, frame, hashtab, attrib — rare in data files
            obj = RObject(ENVSXP, None)
            self.refs.append(obj)
            self.i32()  # locked
            for _ in range(4):
                self.read_object()
            return obj
        if typ in (LISTSXP, LANGSXP, CLOSXP):
            # pairlist node: [attr] [tag] car cdr
            attrs = {}
            if has_attr:
                attrs = self._read_attributes()
            tag = self.read_object() if has_tag else None
            car = self.read_object()
            cdr = self.read_object()
            pairs = [(tag.value if tag else None, car)]
            if cdr is not None and cdr.type in (LISTSXP, LANGSXP):
                pairs.extend(cdr.value)
            obj = RObject(typ, pairs, attrs)
            return obj
        if typ == CHARSXP:
            n = self.i32()
            if n == -1:
                return RObject(CHARSXP, None)
            return RObject(CHARSXP, self._take(n).decode("utf-8", "replace"))
        if typ == LGLSXP:
            n = self.length()
            raw = self.i32s(n)
            val = np.where(raw == R_NA_INT, np.nan, raw.astype(np.float64))
            obj = RObject(LGLSXP, val)
        elif typ == INTSXP:
            n = self.length()
            obj = RObject(INTSXP, self.i32s(n))
        elif typ == REALSXP:
            n = self.length()
            obj = RObject(REALSXP, self.f64s(n))
        elif typ == CPLXSXP:
            n = self.length()
            re = np.frombuffer(self._take(16 * n), dtype=">c16")
            obj = RObject(CPLXSXP, re.astype(np.complex128))
        elif typ == STRSXP:
            n = self.length()
            vals = []
            for _ in range(n):
                c = self.read_object()
                vals.append(c.value if c else None)
            obj = RObject(STRSXP, np.asarray(vals, dtype=object))
        elif typ == VECSXP:
            n = self.length()
            vals = [self.read_object() for _ in range(n)]
            obj = RObject(VECSXP, vals)
        elif typ == RAWSXP:
            n = self.length()
            obj = RObject(RAWSXP, np.frombuffer(self._take(n), dtype=np.uint8))
        elif typ == ALTREP_SXP:
            info = self.read_object()  # class info pairlist
            state = self.read_object()
            self.read_object()  # attributes placeholder
            obj = _decode_altrep(info, state)
        else:
            raise NotImplementedError(f"RData SEXP type {typ} not supported")

        if has_attr:
            obj.attributes = self._read_attributes()
        return obj

    def _read_attributes(self) -> Dict[str, RObject]:
        plist = self.read_object()
        attrs: Dict[str, RObject] = {}
        if plist is None:
            return attrs
        for tag, car in plist.value:
            if tag is not None:
                attrs[tag] = car
        return attrs


def _decode_altrep(info: RObject, state: Optional[RObject]) -> RObject:
    """Decode the common ALTREP payloads found in data files.

    compact_intseq: state = REALSXP (n, start, step)
    wrap-ed vectors: state pairlist (payload, metadata)
    deferred_string: state pairlist with the numeric payload
    """
    name = None
    if info is not None and info.type in (LISTSXP, LANGSXP):
        first = info.value[0][1]
        if first is not None and first.type == SYMSXP:
            name = first.value
    if name == "compact_intseq" and state is not None:
        n, start, step = [int(v) for v in np.asarray(state.value)]
        return RObject(INTSXP, (start + step * np.arange(n)).astype(np.int32))
    if name == "compact_realseq" and state is not None:
        n, start, step = np.asarray(state.value)
        return RObject(REALSXP, start + step * np.arange(int(n)))
    if state is not None and state.type in (LISTSXP, LANGSXP):
        payload = state.value[0][1]
        if payload is not None:
            return payload
    raise NotImplementedError(f"unsupported ALTREP class {name!r}")


def load_rda(path: str) -> Dict[str, RObject]:
    """Load an .rda workspace file -> dict of {name: RObject}."""
    with open(path, "rb") as fh:
        raw = fh.read()
    if raw[:2] == b"\x1f\x8b":
        data = gzip.decompress(raw)
    elif raw[:3] == b"BZh":
        import bz2

        data = bz2.decompress(raw)
    elif raw[:6] == b"\xfd7zXZ\x00":
        import lzma

        data = lzma.decompress(raw)
    else:
        data = raw
    if not data.startswith(b"RDX"):
        raise ValueError(f"{path}: not an RData file")
    version = int(chr(data[3]))
    body = data[5:]  # strip "RDXn\n"
    r = _Reader(body)
    fmt = r._take(2)
    if fmt != b"X\n":
        raise NotImplementedError("only XDR-format RData is supported")
    r.i32()  # serialization version
    r.i32()  # writer R version
    r.i32()  # min reader R version
    if version >= 3:
        enc_len = r.i32()
        r._take(enc_len)  # native encoding string

    out: Dict[str, RObject] = {}
    plist = r.read_object()
    if plist is not None:
        for tag, car in plist.value:
            if tag is not None:
                out[tag] = car
    return out
