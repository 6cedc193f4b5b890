"""ctypes bindings for the port's native host runtime (oslam_host.cpp).

Counterpart of object_slam_tpu/native/loader.py:

* ``decode_image(path)``: synchronous PNG decode;
* ``FramePrefetcher``: a threaded frame pipeline. ``submit`` (rgb, depth,
  masks) paths ahead of time; worker threads decode off the tracking
  thread; ``get`` returns numpy arrays copied out of the runtime's
  buffers, each submitted id once.

The library is built from this directory's source at first use, with g++,
into ``build/native/`` at the repository root (named by the source's
hash, so an edit rebuilds it). There is no fallback: if it does not build
or load, these raise with the compiler's or the loader's message.
"""

from __future__ import annotations

import ctypes as ct
import hashlib
import os
import subprocess
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "oslam_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_ERR_CAP = 1024
_lib = None
_lock = threading.Lock()


def library_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"liboslam_host-{digest}.so")


def build() -> str:
    """Compile the library unless this source's build exists; returns its
    path. Raises RuntimeError with the compiler's output on failure."""
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-fPIC", "-std=c++17", "-shared", "-o", tmp, _SRC,
           "-lz", "-lpthread"]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:
        raise RuntimeError(f"building the native host runtime failed: "
                           f"{' '.join(cmd)}: {e}") from e
    if out.returncode != 0:
        raise RuntimeError(f"building the native host runtime failed: "
                           f"{' '.join(cmd)}\n{out.stderr}")
    os.replace(tmp, so)                # atomic: concurrent builders agree
    return so


def get_lib():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ct.CDLL(build())
        u8p = ct.POINTER(ct.c_uint8)
        ip = ct.POINTER(ct.c_int)
        lib.oslam_loader_create.restype = ct.c_void_p
        lib.oslam_loader_create.argtypes = [ct.c_int, ct.c_int]
        lib.oslam_loader_destroy.argtypes = [ct.c_void_p]
        lib.oslam_submit.argtypes = [ct.c_void_p, ct.c_int, ct.c_char_p,
                                     ct.c_char_p, ct.POINTER(ct.c_char_p),
                                     ct.c_int]
        lib.oslam_submit.restype = ct.c_int
        lib.oslam_wait.argtypes = [
            ct.c_void_p, ct.c_int,
            ct.POINTER(u8p), ip, ip, ip,
            ct.POINTER(u8p), ip, ip, ip,
            ct.POINTER(u8p), ip, ip, ip, ct.c_int,
            ct.c_char_p, ct.c_int]
        lib.oslam_wait.restype = ct.c_int
        lib.oslam_release.argtypes = [ct.c_void_p, ct.c_int]
        lib.oslam_decode.argtypes = [ct.c_char_p, u8p, ct.c_int, ip, ip, ip,
                                     ip, ct.c_char_p, ct.c_int]
        lib.oslam_decode.restype = ct.c_int
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds and loads here (decode_image and
    FramePrefetcher raise with the reason where it does not)."""
    try:
        get_lib()
    except (RuntimeError, OSError):
        return False
    return True


def _shaped(data: np.ndarray, h: int, w: int, c: int, bits: int):
    if bits == 16:
        return data.view(np.uint16).reshape(h, w)
    if c == 1:
        return data.reshape(h, w)
    return data.reshape(h, w, c)


def decode_image(path: str) -> np.ndarray:
    """PNG -> [H, W] uint8 / uint16 or [H, W, 3] uint8 (alpha dropped)."""
    lib = get_lib()
    cap = 64 * 1024 * 1024
    buf = np.empty(cap, np.uint8)
    h, w, c, bits = ct.c_int(), ct.c_int(), ct.c_int(), ct.c_int()
    err = ct.create_string_buffer(_ERR_CAP)
    n = lib.oslam_decode(path.encode(),
                         buf.ctypes.data_as(ct.POINTER(ct.c_uint8)), cap,
                         ct.byref(h), ct.byref(w), ct.byref(c),
                         ct.byref(bits), err, _ERR_CAP)
    if n == -1:
        raise IOError(f"native decode failed: {err.value.decode()}")
    if n < 0:
        raise IOError(f"native decode of {path}: {-n} bytes exceed the "
                      f"{cap}-byte buffer")
    return _shaped(buf[:n], h.value, w.value, c.value, bits.value).copy()


class FramePrefetcher:
    """In-order frame pipeline over the native worker pool."""

    def __init__(self, n_workers: int = 4, capacity: int = 8,
                 max_masks: int = 16):
        self.lib = get_lib()
        self.max_masks = max_masks
        self._pending = set()
        self._handle = self.lib.oslam_loader_create(n_workers, capacity)

    def submit(self, frame_id: int, rgb_path: str,
               depth_path: Optional[str] = None,
               mask_paths: Sequence[str] = ()):
        if self._handle is None:
            raise RuntimeError("the prefetcher is closed")
        if frame_id in self._pending:
            raise ValueError(f"frame {frame_id} is already submitted")
        arr = (ct.c_char_p * len(mask_paths))(
            *[p.encode() for p in mask_paths])
        rc = self.lib.oslam_submit(
            self._handle, frame_id, rgb_path.encode(),
            depth_path.encode() if depth_path else None,
            arr, len(mask_paths))
        if rc != 0:
            raise RuntimeError(f"submitting frame {frame_id} failed")
        self._pending.add(frame_id)

    def get(self, frame_id: int
            ) -> Tuple[np.ndarray, Optional[np.ndarray], List[np.ndarray]]:
        """(rgb or gray, depth or None, masks) of a submitted frame; each
        id is handed out once (a second get would wait forever, so it
        raises KeyError)."""
        if frame_id not in self._pending:
            raise KeyError(f"frame {frame_id} is not pending (never "
                           f"submitted, or already taken)")
        self._pending.discard(frame_id)
        u8p = ct.POINTER(ct.c_uint8)
        rgb_p, dep_p = u8p(), u8p()
        rh, rw, rc_ = ct.c_int(), ct.c_int(), ct.c_int()
        dh, dw, dbits = ct.c_int(), ct.c_int(), ct.c_int()
        mask_ps = (u8p * self.max_masks)()
        mh = (ct.c_int * self.max_masks)()
        mw = (ct.c_int * self.max_masks)()
        nm = ct.c_int()
        err = ct.create_string_buffer(_ERR_CAP)
        rc = self.lib.oslam_wait(
            self._handle, frame_id,
            ct.byref(rgb_p), ct.byref(rh), ct.byref(rw), ct.byref(rc_),
            ct.byref(dep_p), ct.byref(dh), ct.byref(dw), ct.byref(dbits),
            mask_ps, mh, mw, ct.byref(nm), self.max_masks, err, _ERR_CAP)
        if rc != 0:
            raise IOError(f"frame {frame_id} decode failed: "
                          f"{err.value.decode()}")

        def view(ptr, shape, dtype=np.uint8):
            size = int(np.prod(shape)) * np.dtype(dtype).itemsize
            raw = ct.cast(ptr, ct.POINTER(ct.c_uint8 * size)).contents
            return np.frombuffer(raw, dtype=dtype).reshape(shape).copy()

        try:
            if rc_.value == 1:
                rgb = view(rgb_p, (rh.value, rw.value))
            else:
                rgb = view(rgb_p, (rh.value, rw.value, rc_.value))
            depth = None
            if dh.value:
                dt = np.uint16 if dbits.value == 16 else np.uint8
                depth = view(dep_p, (dh.value, dw.value), dt)
            masks = [view(mask_ps[i], (int(mh[i]), int(mw[i])))
                     for i in range(nm.value)]
        finally:
            self.lib.oslam_release(self._handle, frame_id)
        return rgb, depth, masks

    def close(self):
        if self._handle is not None:
            self.lib.oslam_loader_destroy(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
