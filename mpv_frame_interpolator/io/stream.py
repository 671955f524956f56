"""Network/IPC stream backends (stream/stream_* analogs).

The reference opens media through pluggable stream backends (stream/
stream_file.c, stream_lavf.c network protocols).  A serving host's
realistic transports are sockets carrying y4m from a decoder elsewhere on
the machine or rack, plus plain http(s) fetches of interchange files:

    mfi tcp://127.0.0.1:9999       # y4m over TCP
    mfi unix:///run/decoder.sock   # y4m over a unix socket
    mfi http://cdn/clip.y4m        # y4m over http (spool-cached)
    mfi http://cdn/clip.mkv        # container over http; byte-range
                                   # seeking when the server supports it

tcp/unix (and rangeless http) are unseekable; the CLI wraps them in the
spool cache (io/cache.py) so seeking still works within the watched
range, exactly like mpv's demuxer cache over network streams.  Servers
with `Accept-Ranges: bytes` get real O(1) seeks through HttpFile
(stream_lavf.c's http seek-by-reconnect strategy)."""

from __future__ import annotations

import socket
from typing import BinaryIO, Optional
from urllib.parse import urlparse

from mpv_frame_interpolator.utils import get_logger

log = get_logger("stream")

SCHEMES = ("tcp", "unix", "http", "https")


def is_stream_url(path: str) -> bool:
    return any(path.startswith(s + "://") for s in SCHEMES)


def open_stream(url: str, timeout: float = 30.0) -> BinaryIO:
    """Open a stream URL -> binary file object (read side)."""
    parsed = urlparse(url)
    if parsed.scheme == "tcp":
        if not parsed.hostname or not parsed.port:
            raise ValueError(f"tcp stream needs host:port, got {url!r}")
        sock = socket.create_connection(
            (parsed.hostname, parsed.port), timeout=timeout)
        sock.settimeout(None)
        log.info("connected to %s", url)
        return sock.makefile("rb")
    if parsed.scheme == "unix":
        path = parsed.path or parsed.netloc
        sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        sock.connect(path)
        sock.settimeout(None)
        log.info("connected to %s", url)
        return sock.makefile("rb")
    if parsed.scheme in ("http", "https"):
        import urllib.request
        resp = urllib.request.urlopen(url, timeout=timeout)
        log.info("GET %s -> %s", url, resp.status)
        return resp
    raise ValueError(f"unsupported stream scheme {parsed.scheme!r} "
                     f"(supported: {SCHEMES})")


class HttpFile:
    """Seekable read-only file over http(s) byte ranges.

    The container demuxers (io/mkv.py, io/mp4.py) need read/seek/tell;
    this serves them straight off a CDN the way the reference's
    stream_lavf http backend does: sequential reads ride ONE open
    response, a seek drops it and issues `Range: bytes=<pos>-` on the
    next read (reconnect-on-seek).  Requires `Accept-Ranges: bytes`
    (probe with supports_ranges)."""

    def __init__(self, url: str, timeout: float = 30.0):
        import urllib.request
        self._url = url
        self._timeout = timeout
        self._request = urllib.request
        self._pos = 0
        self._resp = None          # open response positioned at _pos
        head = self._request.Request(url, method="HEAD")
        with self._request.urlopen(head, timeout=timeout) as r:
            self._size = int(r.headers.get("Content-Length", -1))
            self._ranges = r.headers.get("Accept-Ranges", "") == "bytes"
        if not self._ranges:
            raise ValueError(f"{url!r}: server does not accept byte "
                             "ranges (use the spool cache path)")

    def _ensure_resp(self):
        if self._resp is None:
            req = self._request.Request(
                self._url, headers={"Range": f"bytes={self._pos}-"})
            self._resp = self._request.urlopen(req, timeout=self._timeout)

    def read(self, n: int = -1) -> bytes:
        if self._size >= 0 and self._pos >= self._size:
            return b""
        self._ensure_resp()
        data = self._resp.read(n) if n >= 0 else self._resp.read()
        self._pos += len(data)
        return data

    def seek(self, offset: int, whence: int = 0) -> int:
        if whence == 0:
            new = offset
        elif whence == 1:
            new = self._pos + offset
        elif whence == 2:
            if self._size < 0:
                raise OSError("size unknown; cannot seek from end")
            new = self._size + offset
        else:
            raise ValueError(f"bad whence {whence}")
        if new != self._pos:
            if self._resp is not None:
                self._resp.close()
                self._resp = None
            self._pos = max(new, 0)
        return self._pos

    def tell(self) -> int:
        return self._pos

    def seekable(self) -> bool:
        return True

    def close(self):
        if self._resp is not None:
            self._resp.close()
            self._resp = None


def supports_ranges(url: str, timeout: float = 30.0) -> bool:
    """Probe whether the server honors byte ranges (HEAD Accept-Ranges)."""
    import urllib.request
    try:
        req = urllib.request.Request(url, method="HEAD")
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.headers.get("Accept-Ranges", "") == "bytes"
    except Exception:  # noqa: BLE001 - any failure -> streaming fallback
        return False


def open_http_file(url: str, timeout: float = 30.0) -> Optional[HttpFile]:
    """HttpFile when the server supports ranges, else None."""
    try:
        return HttpFile(url, timeout=timeout)
    except Exception as e:  # noqa: BLE001
        log.info("no byte-range support for %s (%s); streaming", url, e)
        return None
