"""URI-aware filesystem access — the analog of the reference's Hadoop
`FileSystem` indirection (`io/DfsUtils.scala:24-85`), which lets state blobs
and metric histories live on HDFS/S3 instead of one machine's disk.

Resolution order for a path with a scheme (``s3://``, ``gs://``,
``memory://``, ``hdfs://``, ...):

1. **fsspec** (`fsspec.core.url_to_fs`) — covers every registered fsspec
   protocol, including the in-memory filesystem used by tests and any
   optional backend the operator has installed (s3fs, gcsfs, adlfs...).
2. **pyarrow.fs** (`FileSystem.from_uri`) — pyarrow ships NATIVE S3, GCS
   and HDFS clients, so object stores work with no extra Python packages.

Schemeless paths (and ``file://``) use the local filesystem directly and
keep their exact previous behavior (atomic rename writes, os.makedirs).
Object-store writes are single-put (the store's own atomicity), matching
the reference's overwrite semantics on `FileSystem.create`.
"""

from __future__ import annotations

import os
import re
import tempfile
from contextlib import contextmanager
from typing import IO, Iterator, Optional, Tuple

_SCHEME_RE = re.compile(r"^[a-zA-Z][a-zA-Z0-9+.-]*://")

#: fsspec filesystem instances are cached per (protocol, storage options) by
#: fsspec itself; pyarrow from_uri is cheap. No extra caching needed here.


def _scheme_of(path: str) -> Optional[str]:
    m = _SCHEME_RE.match(path)
    if not m:
        return None
    return m.group(0)[:-3].lower()


def is_local(path: str) -> bool:
    scheme = _scheme_of(path)
    return scheme is None or scheme == "file"


def _strip_file_scheme(path: str) -> str:
    return path[7:] if path.startswith("file://") else path


class _FsspecFs:
    """Adapter over an fsspec AbstractFileSystem."""

    def __init__(self, fs, path: str):
        self.fs = fs
        self.path = path

    def open(self, mode: str) -> IO:
        return self.fs.open(self.path, mode)

    def exists(self) -> bool:
        return self.fs.exists(self.path)

    def makedirs(self) -> None:
        self.fs.makedirs(self.path, exist_ok=True)


class _ArrowFs:
    """Adapter over a pyarrow.fs.FileSystem."""

    def __init__(self, fs, path: str):
        self.fs = fs
        self.path = path

    def open(self, mode: str) -> IO:
        if "r" in mode:
            f = self.fs.open_input_file(self.path)
        else:
            f = self.fs.open_output_stream(self.path)
        if "b" in mode:
            return f
        import io as _io

        return _io.TextIOWrapper(f, encoding="utf-8")

    def exists(self) -> bool:
        import pyarrow.fs as pafs

        return self.fs.get_file_info(self.path).type != pafs.FileType.NotFound

    def makedirs(self) -> None:
        self.fs.create_dir(self.path, recursive=True)


def _resolve_remote(path: str):
    try:
        import fsspec

        fs, stripped = fsspec.core.url_to_fs(path)
        return _FsspecFs(fs, stripped)
    except (ImportError, ValueError):
        pass
    import pyarrow.fs as pafs

    fs, stripped = pafs.FileSystem.from_uri(path)
    return _ArrowFs(fs, stripped)


@contextmanager
def open_file(path: str, mode: str = "r") -> Iterator[IO]:
    """Open ``path`` for reading or writing, any supported scheme."""
    if is_local(path):
        with open(_strip_file_scheme(path), mode) as f:
            yield f
        return
    f = _resolve_remote(path).open(mode)
    try:
        yield f
    finally:
        f.close()


def exists(path: str) -> bool:
    if is_local(path):
        return os.path.exists(_strip_file_scheme(path))
    return _resolve_remote(path).exists()


def makedirs(path: str) -> None:
    if is_local(path):
        os.makedirs(_strip_file_scheme(path), exist_ok=True)
        return
    # object stores have no real directories; create is best-effort (the
    # memory filesystem wants it, S3/GCS ignore it)
    try:
        _resolve_remote(path).makedirs()
    except (NotImplementedError, OSError):
        pass


def join(base: str, *parts: str) -> str:
    """Path join that never turns URI '//' into '/'."""
    if is_local(base):
        return os.path.join(_strip_file_scheme(base), *parts)
    out = base.rstrip("/")
    for p in parts:
        out += "/" + p.strip("/")
    return out


def remove_file(path: str) -> None:
    """Delete one file, any supported scheme. Raises on failure (missing
    file included) — callers decide whether absence is fine."""
    if is_local(path):
        os.remove(_strip_file_scheme(path))
        return
    adapter = _resolve_remote(path)
    fs = adapter.fs
    if hasattr(fs, "rm_file"):  # fsspec
        fs.rm_file(adapter.path)
    elif hasattr(fs, "rm"):  # older fsspec
        fs.rm(adapter.path)
    else:  # pyarrow.fs
        fs.delete_file(adapter.path)


def remove_dir(path: str) -> None:
    """Delete a directory tree, any supported scheme."""
    if is_local(path):
        import shutil

        shutil.rmtree(_strip_file_scheme(path), ignore_errors=True)
        return
    adapter = _resolve_remote(path)
    fs = adapter.fs
    if hasattr(fs, "rm"):  # fsspec
        fs.rm(adapter.path, recursive=True)
    else:  # pyarrow.fs
        fs.delete_dir(adapter.path)


def list_dirs(path: str) -> list:
    """Immediate child directory NAMES of ``path``, sorted; [] when the
    path does not exist. Other failures (auth, network) RAISE — a store
    misconfiguration must not read as an empty listing."""
    if is_local(path):
        local = _strip_file_scheme(path)
        if not os.path.isdir(local):
            return []
        return sorted(
            e for e in os.listdir(local)
            if os.path.isdir(os.path.join(local, e))
        )
    adapter = _resolve_remote(path)
    fs = adapter.fs
    if hasattr(fs, "ls"):  # fsspec
        try:
            entries = fs.ls(adapter.path, detail=True)
        except FileNotFoundError:
            return []
        return sorted(
            os.path.basename(str(e["name"]).rstrip("/"))
            for e in entries
            if e.get("type") == "directory"
        )
    import pyarrow.fs as pafs

    infos = fs.get_file_info(
        pafs.FileSelector(adapter.path, allow_not_found=True)
    )
    return sorted(
        os.path.basename(i.path.rstrip("/"))
        for i in infos
        if i.type == pafs.FileType.Directory
    )


def list_files(path: str) -> list:
    """Immediate child FILE names of ``path``, sorted; [] when the path
    does not exist. Other failures (auth, network) RAISE — the same
    contract as :func:`list_dirs` (a store misconfiguration must not read
    as an empty listing)."""
    if is_local(path):
        local = _strip_file_scheme(path)
        if not os.path.isdir(local):
            return []
        return sorted(
            e for e in os.listdir(local)
            if os.path.isfile(os.path.join(local, e))
        )
    adapter = _resolve_remote(path)
    fs = adapter.fs
    if hasattr(fs, "ls"):  # fsspec
        try:
            entries = fs.ls(adapter.path, detail=True)
        except FileNotFoundError:
            return []
        return sorted(
            os.path.basename(str(e["name"]).rstrip("/"))
            for e in entries
            if e.get("type") == "file"
        )
    import pyarrow.fs as pafs

    infos = fs.get_file_info(
        pafs.FileSelector(adapter.path, allow_not_found=True)
    )
    return sorted(
        os.path.basename(i.path)
        for i in infos
        if i.type == pafs.FileType.File
    )


def write_text_atomic(path: str, payload: str) -> None:
    """Local: write-to-temp + rename so a crash mid-write never corrupts the
    target (the reference relies on HDFS create-overwrite the same way).
    Remote: single-put write — object stores make the put itself atomic."""
    if is_local(path):
        local = _strip_file_scheme(path)
        directory = os.path.dirname(os.path.abspath(local)) or "."
        os.makedirs(directory, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(payload)
            os.replace(tmp, local)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return
    with open_file(path, "w") as f:
        f.write(payload)


def read_parquet_table(path, columns=None):
    """Parquet → pyarrow Table for any supported scheme (reference readers
    go through Hadoop input streams the same way)."""
    import pyarrow.parquet as pq

    if isinstance(path, (list, tuple)):
        paths = [str(p) for p in path]
        if all(is_local(p) for p in paths):
            return pq.read_table([_strip_file_scheme(p) for p in paths], columns=columns)
        # remote multi-file read (day-partitioned data on shared storage):
        # all paths must resolve to one filesystem
        resolved = [_resolve_remote(p) for p in paths]
        first = resolved[0]
        if any(type(r.fs) is not type(first.fs) for r in resolved):
            raise ValueError(
                f"all parquet paths must share one filesystem scheme, got {paths}"
            )
        return pq.read_table(
            [r.path for r in resolved], columns=columns, filesystem=first.fs
        )
    if is_local(str(path)):
        return pq.read_table(_strip_file_scheme(str(path)), columns=columns)
    fs = _resolve_remote(str(path))
    return pq.read_table(fs.path, columns=columns, filesystem=fs.fs)


def write_parquet_table(table, path: str) -> None:
    import pyarrow.parquet as pq

    if is_local(path):
        pq.write_table(table, _strip_file_scheme(path))
        return
    fs = _resolve_remote(path)
    pq.write_table(table, fs.path, filesystem=fs.fs)
