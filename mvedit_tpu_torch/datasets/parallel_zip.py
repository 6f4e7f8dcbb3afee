"""Thread-safe zip reading via mmap + EOCD parsing; a copy of
`mvedit_tpu/datasets/parallel_zip.py`.

Rebuilds `lib/datasets/parallel_zip.py:17-166`: python's ZipFile shares one
file handle (lock contention across loader threads); this reader mmaps the
archive, parses the central directory once, and serves each read as an
independent slice + decompress — safe from any thread/process.
"""
import mmap
import os
import struct
import zlib

__all__ = ["ParallelZipFile"]

_EOCD_SIG = 0x06054B50
_EOCD64_SIG = 0x06064B50
_EOCD64_LOC_SIG = 0x07064B50
_CDH_SIG = 0x02014B50
_LFH_SIG = 0x04034B50


class ParallelZipFile:
    def __init__(self, path):
        self.path = path
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self._entries = {}
        self._parse_central_directory()

    def _parse_central_directory(self):
        mm = self._mm
        # find EOCD in the last 64KB + 22 bytes
        tail_start = max(0, len(mm) - 65557)
        idx = mm.rfind(struct.pack("<I", _EOCD_SIG), tail_start)
        if idx < 0:
            raise ValueError("not a zip file (no EOCD)")
        (_, _, _, _, n_entries, _, cd_offset) = struct.unpack(
            "<IHHHHII", mm[idx:idx + 20])
        cd_size = struct.unpack("<I", mm[idx + 12:idx + 16])[0]
        if cd_offset == 0xFFFFFFFF or n_entries == 0xFFFF:
            # zip64: locate EOCD64
            loc = mm.rfind(struct.pack("<I", _EOCD64_LOC_SIG), tail_start,
                           idx)
            if loc >= 0:
                eocd64_off = struct.unpack("<Q", mm[loc + 8:loc + 16])[0]
                (n_entries, cd_size, cd_offset) = struct.unpack(
                    "<QQQ", mm[eocd64_off + 32:eocd64_off + 56])
        pos = cd_offset
        for _ in range(n_entries):
            sig = struct.unpack("<I", mm[pos:pos + 4])[0]
            if sig != _CDH_SIG:
                break
            (method, csize, usize, nlen, elen, clen) = struct.unpack(
                "<H II H H H",
                mm[pos + 10:pos + 12] + mm[pos + 20:pos + 28]
                + mm[pos + 28:pos + 34])
            lfh_offset = struct.unpack("<I", mm[pos + 42:pos + 46])[0]
            name = mm[pos + 46:pos + 46 + nlen].decode("utf-8")
            # zip64 extras
            extra = mm[pos + 46 + nlen:pos + 46 + nlen + elen]
            ep = 0
            while ep + 4 <= len(extra):
                hid, hsz = struct.unpack("<HH", extra[ep:ep + 4])
                if hid == 0x0001:
                    vals = []
                    vp = ep + 4
                    for need in (usize == 0xFFFFFFFF, csize == 0xFFFFFFFF,
                                 lfh_offset == 0xFFFFFFFF):
                        if need:
                            vals.append(struct.unpack(
                                "<Q", extra[vp:vp + 8])[0])
                            vp += 8
                        else:
                            vals.append(None)
                    if vals[0] is not None:
                        usize = vals[0]
                    if vals[1] is not None:
                        csize = vals[1]
                    if vals[2] is not None:
                        lfh_offset = vals[2]
                ep += 4 + hsz
            self._entries[name] = (lfh_offset, method, csize, usize)
            pos += 46 + nlen + elen + clen

    def namelist(self):
        return list(self._entries)

    def read(self, name):
        lfh_offset, method, csize, usize = self._entries[name]
        mm = self._mm
        sig, = struct.unpack("<I", mm[lfh_offset:lfh_offset + 4])
        assert sig == _LFH_SIG, "corrupt local header"
        nlen, elen = struct.unpack("<HH",
                                   mm[lfh_offset + 26:lfh_offset + 30])
        start = lfh_offset + 30 + nlen + elen
        raw = mm[start:start + csize]
        if method == 0:
            return bytes(raw)
        if method == 8:
            return zlib.decompress(raw, -15, usize or 0)
        raise ValueError(f"unsupported compression method {method}")

    def close(self):
        self._mm.close()
        self._f.close()
