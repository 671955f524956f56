"""Column subsampling without a strided slice on the minor dimension.

Every device-side ``x[..., off::s]`` on a wide plane goes through
:func:`col_take`, which expresses the same selection as reshape +
trailing index.  The two forms are bit-identical (element-equal
asserted in tests/test_lanes.py).  The rewrite answered a layout cost
of the accelerator this code was first written for; whether it still
pays on the GPU is not measured (ROADMAP design debt 4).

Row strides stay as plain slices.
"""

from __future__ import annotations


def col_take(x, s: int, offset: int = 0):
    """``x[..., offset::s]`` without the lane-stride slice.

    Bit-identical for any array whose trailing dimension is a multiple
    of ``s`` (the common case for frame planes); falls back to the
    plain slice otherwise.  ``offset`` must be < ``s``.
    """
    if s == 1:
        return x if offset == 0 else x[..., offset:]
    w = x.shape[-1]
    if w % s:
        return x[..., offset::s]
    return x.reshape(*x.shape[:-1], w // s, s)[..., offset]


def deinterleave_uv(uv):
    """NV12 interleaved UV plane -> (u, v) half-width planes.

    Device-side analog of frame.split_chroma (which is host NumPy);
    equals ``(uv[:, 0::2], uv[:, 1::2])`` bit-exactly.
    """
    return col_take(uv, 2, 0), col_take(uv, 2, 1)
