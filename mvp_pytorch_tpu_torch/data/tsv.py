"""TSV storage with .lineidx random access: this package's copy of the JAX
package's `data/tsv.py` (`TSVFile`, `build_lineidx`, `tsv_writer` and the
`tsv_concat` / `tsv_reorder` / `tsv_delete` helpers).

Parity target: reference `oscar/utils/tsv_file.py` (TSVFile: on-demand
.lineidx sidecar generation, seek(idx) random access, pid-change reopen for
forked worker safety) and `oscar/utils/tsv_file_ops.py` (atomic
tmp-then-rename writer). This format is the framework's feature/caption
storage contract (`predictions.tsv` + `imageid2idx.json`).
"""

from __future__ import annotations

import os
from typing import Iterable, List, Optional, Sequence


def _lineidx_path(tsv_path: str) -> str:
    return os.path.splitext(tsv_path)[0] + ".lineidx"


def build_lineidx(tsv_path: str) -> str:
    """Generate the byte-offset sidecar (atomic)."""
    idx_path = _lineidx_path(tsv_path)
    tmp = idx_path + ".tmp"
    with open(tsv_path, "rb") as f, open(tmp, "w") as out:
        pos = 0
        for line in f:
            out.write(f"{pos}\n")
            pos += len(line)
    os.replace(tmp, idx_path)
    return idx_path


class TSVFile:
    """Random-access TSV reader; safe across process forks AND threads.

    The reference reopens on pid change for forked DataLoader workers
    (tsv_file.py:77-85); the handle is also thread-local (seek+readline on
    a shared fp would interleave). It pickles without its handles, so a
    spawned loader worker opens its own."""

    def __init__(self, tsv_path: str, generate_lineidx: bool = True):
        import threading
        self.tsv_path = tsv_path
        self.lineidx_path = _lineidx_path(tsv_path)
        if not os.path.isfile(self.lineidx_path) and generate_lineidx:
            build_lineidx(tsv_path)
        self._local = threading.local()
        self._lineidx: Optional[List[int]] = None

    def __getstate__(self):
        state = dict(self.__dict__)
        del state["_local"]
        return state

    def __setstate__(self, state):
        import threading
        self.__dict__.update(state)
        self._local = threading.local()

    def _ensure_lineidx(self):
        if self._lineidx is None:
            with open(self.lineidx_path) as f:
                self._lineidx = [int(l) for l in f if l.strip()]

    def _fp(self):
        loc = self._local
        if getattr(loc, "fp", None) is None or loc.pid != os.getpid():
            loc.fp = open(self.tsv_path, "rb")
            loc.pid = os.getpid()
        return loc.fp

    def num_rows(self) -> int:
        self._ensure_lineidx()
        return len(self._lineidx)

    def __len__(self) -> int:
        return self.num_rows()

    def seek(self, idx: int) -> List[str]:
        # rstrip \r too: CRLF-prepared TSVs otherwise leave '\r' glued to
        # the last field (the reference strips per field, tsv_file.py)
        return self.seek_raw(idx).decode("utf-8").split("\t")

    def seek_bytes(self, idx: int) -> List[bytes]:
        """seek() without the utf-8 decode: raw byte fields.

        Feature rows carry ~0.5 MB of base64 per line; decoding that to
        str and re-splitting costs more than the base64 decode itself
        (profiled: ~40% of FeatureStore.get). b64decode/json.loads accept
        bytes directly, so the hot path never materializes the str."""
        return self.seek_raw(idx).split(b"\t")

    def seek_raw(self, idx: int) -> bytes:
        """Raw row bytes (trailing newline stripped), fetched in ONE pread.

        The .lineidx sidecar bounds every line (next offset, or file size
        for the last row), so the row needs no newline scan and no
        buffered-readline chunk reassembly — on the ~0.5 MB feature rows
        that scan cost more than the read itself (profiled r5, corpus
        scale: 1.1 ms/row readline -> ~0.1 ms pread from page cache).
        os.pread leaves the handle's offset alone and is safe across
        threads sharing the fd."""
        self._ensure_lineidx()
        if idx < 0:
            idx += len(self._lineidx)
        off = self._lineidx[idx]
        fd = self._fp().fileno()
        if idx + 1 < len(self._lineidx):
            end = self._lineidx[idx + 1]
        else:
            # fstat the OPEN fd, not the path: tsv_writer replaces files
            # by rename, and a concurrent replacement must not pair the
            # old inode's offsets with the new file's size
            end = os.fstat(fd).st_size
        cnt = end - off
        if cnt > 65536:
            # big rows: bytes.rstrip always reallocates, so stripping the
            # newline off a ~0.5 MB feature row copies the whole row (r5
            # ingest profile). Probe the tail bytes with a ~µs pread to
            # make the content pread EXACT instead.
            k = min(8, cnt)
            tail = os.pread(fd, k, end - k)
            strip = 0
            for ch in reversed(tail):
                if ch in (10, 13):
                    strip += 1
                else:
                    break
            if strip < len(tail):  # saw a non-newline byte: count exact
                return os.pread(fd, cnt - strip, off)
            # degenerate (≥8 trailing newline bytes, or a short read):
            # the full-read + rstrip path below owns the edge
        data = os.pread(fd, cnt, off)
        return data.rstrip(b"\r\n")

    def __getitem__(self, idx: int) -> List[str]:
        return self.seek(idx)


def tsv_concat(sources: Sequence[str], out_path: str) -> None:
    """Concatenate TSVs (reference tsv_file_ops concat helper), dropping
    empty lines. Streams the sources line by line: they need no .lineidx
    (and get none; they may live in read-only dataset dirs)."""
    def rows():
        for src in sources:
            with open(src, "rb") as f:
                for line in f:
                    line = line.decode("utf-8").rstrip("\r\n")
                    if line:
                        yield line.split("\t")
    tsv_writer(rows(), out_path)


def tsv_reorder(src: str, order: Sequence[int], out_path: str) -> None:
    """Write rows of `src` in the given index order (reorder helper)."""
    t = TSVFile(src)
    tsv_writer((t.seek(i) for i in order), out_path)


def tsv_delete(src: str, drop: Sequence[int], out_path: str) -> None:
    """Write `src` without the dropped row indices (delete helper)."""
    t = TSVFile(src)
    dropset = set(int(i) for i in drop)
    tsv_writer((t.seek(i) for i in range(len(t)) if i not in dropset),
               out_path)


def tsv_writer(rows: Iterable[Sequence], tsv_path: str) -> None:
    """Atomic write: tmp file + rename, with .lineidx emitted alongside
    (reference tsv_file_ops.py:12-24)."""
    os.makedirs(os.path.dirname(tsv_path) or ".", exist_ok=True)
    tmp = tsv_path + ".tmp"
    idx_tmp = _lineidx_path(tsv_path) + ".tmp"
    with open(tmp, "wb") as f, open(idx_tmp, "w") as idx:
        pos = 0
        for row in rows:
            line = ("\t".join(str(c) for c in row) + "\n").encode("utf-8")
            idx.write(f"{pos}\n")
            f.write(line)
            pos += len(line)
    # lineidx FIRST: a crash between the two renames then pairs the NEW
    # index with the OLD tsv, where stale offsets fail loudly (short
    # reads) — the reverse order pairs new tsv with old index, which
    # returns silently garbled rows
    os.replace(idx_tmp, _lineidx_path(tsv_path))
    os.replace(tmp, tsv_path)
