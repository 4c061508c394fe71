"""PLY point-cloud I/O in numpy (copy of psulvsb_tpu/io/ply.py).

Equivalent of teaser::PLYReader / teaser::PLYWriter
(ply_io.cc:26-110, which wraps tinyply and
handles float32/float64 vertex elements). Supports ascii 1.0 and
binary_little_endian 1.0, reads x/y/z from the `vertex` element (extra
properties are skipped), writes binary float32 by default.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path: str, dtype=np.float32) -> np.ndarray:
    """Read vertex x/y/z from a PLY file. Returns (3, N)."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, np_dtype, is_list)])
        cur = None
        while True:
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: unexpected EOF in header")
            tok = line.decode("ascii", "replace").split()
            if not tok:
                continue
            if tok[0] == "format":
                fmt = tok[1]
            elif tok[0] == "comment":
                continue
            elif tok[0] == "element":
                cur = (tok[1], int(tok[2]), [])
                elements.append(cur)
            elif tok[0] == "property":
                if cur is None:
                    raise ValueError(f"{path}: property before element")
                if tok[1] == "list":
                    cur[2].append((tok[4], (_DTYPES[tok[2]], _DTYPES[tok[3]]), True))
                else:
                    cur[2].append((tok[2], _DTYPES[tok[1]], False))
            elif tok[0] == "end_header":
                break

        if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
            raise ValueError(f"{path}: unsupported format {fmt}")
        endian = ">" if fmt == "binary_big_endian" else "<"

        verts = None
        for name, count, props in elements:
            if name == "vertex":
                if any(is_list for _, _, is_list in props):
                    raise ValueError(f"{path}: list property on vertex")
                rec = np.dtype([(p, endian + d) for p, d, _ in props])
                if fmt == "ascii":
                    rows = []
                    for _ in range(count):
                        rows.append(
                            tuple(
                                np.dtype(endian + d).type(v)
                                for v, (_, d, _l) in zip(
                                    f.readline().split(), props
                                )
                            )
                        )
                    data = np.array(rows, dtype=rec)
                else:
                    data = np.frombuffer(f.read(rec.itemsize * count), dtype=rec)
                verts = np.stack(
                    [data["x"], data["y"], data["z"]]
                ).astype(dtype)
            else:
                # Skip a non-vertex element's payload.
                if fmt == "ascii":
                    for _ in range(count):
                        f.readline()
                else:
                    if any(is_list for _, _, is_list in props):
                        # Parse row by row (faces etc.).
                        for _ in range(count):
                            for _p, d, is_list in props:
                                if is_list:
                                    cnt_dt = np.dtype(endian + d[0])
                                    k = int(
                                        np.frombuffer(
                                            f.read(cnt_dt.itemsize), cnt_dt
                                        )[0]
                                    )
                                    f.read(np.dtype(endian + d[1]).itemsize * k)
                                else:
                                    f.read(np.dtype(endian + d).itemsize)
                    else:
                        rec = np.dtype([(p, endian + d) for p, d, _ in props])
                        f.read(rec.itemsize * count)
        if verts is None:
            raise ValueError(f"{path}: no vertex element")
        return verts


def write_ply(path: str, points: np.ndarray, binary: bool = True) -> None:
    """Write a (3, N) point matrix as a PLY vertex cloud (float32)."""
    pts = np.asarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[0] != 3:
        raise ValueError("points must be (3, N)")
    n = pts.shape[1]
    fmt = "binary_little_endian" if binary else "ascii"
    header = (
        f"ply\nformat {fmt} 1.0\nelement vertex {n}\n"
        "property float x\nproperty float y\nproperty float z\nend_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        rows = np.ascontiguousarray(pts.T.astype("<f4"))
        if binary:
            f.write(rows.tobytes())
        else:
            np.savetxt(f, rows, fmt="%.8g")
