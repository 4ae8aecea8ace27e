"""Native (C++) host-runtime components.

The reference implements its whole runtime natively (Rust); here the device
compute path is XLA and the native tier covers the host-side combinatorics
that neither vectorises nor jits: currently the octree interaction-list
builder. The shared library is compiled on first use with the system g++
and cached next to the source; everything degrades gracefully to the numpy
implementation when no compiler is available
(set ``FERREUS_RBF_NATIVE=0`` to force the fallback).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_SRC = os.path.join(os.path.dirname(__file__), "treebuild.cpp")
_SO = os.path.join(os.path.dirname(__file__), "_treebuild.so")


def _compile() -> bool:
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", _SRC, "-o", _SO],
            check=True,
            capture_output=True,
            timeout=300,
        )
        return True
    except Exception:
        return False


def _load():
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("FERREUS_RBF_NATIVE", "1") == "0":
            return None
        if not os.path.exists(_SO) or os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(_SO)
        except OSError:
            return None
        lib.ferreus_build_lists.restype = ctypes.c_void_p
        lib.ferreus_build_lists.argtypes = [
            ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8),
        ]
        for name in ("ferreus_num_v", "ferreus_num_u", "ferreus_num_w"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p]
        lib.ferreus_copy_lists.restype = None
        lib.ferreus_copy_lists.argtypes = [ctypes.c_void_p] + [
            ctypes.POINTER(ctypes.c_int64)
        ] * 3
        lib.ferreus_free.restype = None
        lib.ferreus_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
        return _LIB


def native_available() -> bool:
    return _load() is not None


def build_interaction_lists(anchors, levels, parent, children, is_leaf, has_points, depth):
    """Native u/v/w pair lists; returns None when the library is unavailable."""
    lib = _load()
    if lib is None:
        return None

    anchors = np.ascontiguousarray(anchors, np.int64)
    levels64 = np.ascontiguousarray(levels, np.int64)
    parent = np.ascontiguousarray(parent, np.int64)
    children = np.ascontiguousarray(children, np.int64)
    is_leaf8 = np.ascontiguousarray(is_leaf, np.uint8)
    has_points8 = np.ascontiguousarray(has_points, np.uint8)

    def p64(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

    def p8(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))

    handle = lib.ferreus_build_lists(
        anchors.shape[0], anchors.shape[1], int(depth),
        p64(anchors), p64(levels64), p64(parent), p64(children),
        p8(is_leaf8), p8(has_points8),
    )
    try:
        nv = lib.ferreus_num_v(handle)
        nu = lib.ferreus_num_u(handle)
        nw = lib.ferreus_num_w(handle)
        v = np.empty((nv, 3), np.int64)
        u = np.empty((nu, 2), np.int64)
        w = np.empty((nw, 2), np.int64)
        lib.ferreus_copy_lists(handle, p64(v), p64(u), p64(w))
    finally:
        lib.ferreus_free(handle)
    return v, u, w
