"""Artifact resolution: this package's copy of the JAX package's
`utils/file_utils.py` (reference `pytorch_transformers/file_utils.py:93`
`cached_path`), local branch only.

A local path or a `file://` URL passes through (a missing one raises
`FileNotFoundError`). A remote URL (http, https, s3, gs) resolves to its
cache file, named by the sha256 of the URL as the JAX package names it; a
URL whose file is not in the cache raises `RuntimeError` naming the cache
path. Nothing is fetched: the file is put there by whoever has the network.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional
from urllib.parse import urlparse

DEFAULT_CACHE = os.path.join("~", ".cache", "mvp_pytorch_tpu")
REMOTE_SCHEMES = ("http", "https", "s3", "gs")


def url_to_filename(url: str) -> str:
    """The cache file's name of `url`: the hex sha256 of the URL."""
    return hashlib.sha256(url.encode()).hexdigest()


def cached_path(path_or_url: str, cache_dir: Optional[str] = None) -> str:
    """The local file of `path_or_url` (see the module docstring)."""
    cache_dir = cache_dir or os.path.expanduser(DEFAULT_CACHE)
    parsed = urlparse(path_or_url)
    if parsed.scheme in ("", "file"):
        local = parsed.path if parsed.scheme == "file" else path_or_url
        if not os.path.exists(local):
            raise FileNotFoundError(local)
        return local
    if parsed.scheme in REMOTE_SCHEMES:
        cached = os.path.join(cache_dir, url_to_filename(path_or_url))
        if os.path.exists(cached):
            return cached
        raise RuntimeError(f"{path_or_url} is not cached at {cached}, and "
                           f"this package fetches nothing: put the file "
                           f"there")
    raise ValueError(f"unsupported scheme: {path_or_url}")
