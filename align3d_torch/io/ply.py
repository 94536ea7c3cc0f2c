"""PLY read/write (port of ``align3d_tpu/io/ply.py``; reference ``src/io/ply.rs``).

Self-contained parser/writer — reads ASCII and binary little/big-endian PLY
with the vertex properties the reference understands (x/y/z, nx/ny/nz,
red/green/blue) and triangular faces (quads are rejected as in the
reference's typed parser); writes ASCII PLY with optional normals, colors
and faces matching the reference's element layout (ply.rs:144-236).
"""

from __future__ import annotations

import numpy as np

from align3d_torch.io.geometry import Geometry

_DTYPES = {
    "char": "i1",
    "int8": "i1",
    "uchar": "u1",
    "uint8": "u1",
    "short": "i2",
    "int16": "i2",
    "ushort": "u2",
    "uint16": "u2",
    "int": "i4",
    "int32": "i4",
    "uint": "u4",
    "uint32": "u4",
    "float": "f4",
    "float32": "f4",
    "double": "f8",
    "float64": "f8",
}


class PlyError(ValueError):
    pass


def read_ply(filepath) -> Geometry:
    with open(filepath, "rb") as f:
        data = f.read()

    header_end = data.find(b"end_header")
    if header_end < 0:
        raise PlyError("missing end_header")
    header_end = data.index(b"\n", header_end) + 1
    header = data[:header_end].decode("ascii", errors="replace").splitlines()
    body = data[header_end:]

    fmt = None
    elements: list[tuple[str, int, list]] = []  # (name, count, props)
    for line in header:
        tok = line.strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], "list", tok[2], tok[3]))
            else:
                elements[-1][2].append((tok[2], "scalar", tok[1]))

    points = normals = colors = faces = None
    offset = 0
    ascii_lines = body.decode("ascii").split("\n") if fmt == "ascii" else None
    ascii_idx = 0
    endian = "<" if fmt == "binary_little_endian" else ">"

    for name, count, props in elements:
        if name == "vertex":
            cols = {}
            if fmt == "ascii":
                rows = []
                for _ in range(count):
                    rows.append(ascii_lines[ascii_idx].split())
                    ascii_idx += 1
                arr = np.asarray(rows, dtype=np.float64)
                for ci, p in enumerate(props):
                    cols[p[0]] = arr[:, ci]
            else:
                np_dtype = np.dtype([(p[0], endian + _DTYPES[p[2]]) for p in props])
                arr = np.frombuffer(body, dtype=np_dtype, count=count, offset=offset)
                offset += np_dtype.itemsize * count
                for p in props:
                    cols[p[0]] = arr[p[0]].astype(np.float64)

            points = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
            if all(k in cols for k in ("nx", "ny", "nz")):
                normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1).astype(
                    np.float32
                )
            if all(k in cols for k in ("red", "green", "blue")):
                colors = np.stack(
                    [cols["red"], cols["green"], cols["blue"]], axis=1
                ).astype(np.uint8)
        elif name == "face":
            rows = []
            if fmt == "ascii":
                for _ in range(count):
                    tok = ascii_lines[ascii_idx].split()
                    ascii_idx += 1
                    n = int(tok[0])
                    rows.append([int(t) for t in tok[1 : 1 + n]])
            else:
                cnt_dt, idx_dt = props[0][2], props[0][3]
                cnt_size = int(_DTYPES[cnt_dt][1])
                idx_size = int(_DTYPES[idx_dt][1])
                # Fast path: every face a triangle (the only layout the
                # reference accepts anyway) -> one fixed-stride structured
                # read instead of a per-face Python loop.
                tri_dt = np.dtype(
                    [
                        ("n", endian + _DTYPES[cnt_dt]),
                        ("idx", endian + _DTYPES[idx_dt], (3,)),
                    ]
                )
                # When faces are the LAST element, the triangle hypothesis
                # must also consume the block exactly — "every stride-13
                # count byte reads 3" can hold coincidentally on a
                # mixed-polygon file, and the byte-count check unmasks
                # that; the slow path below then raises on the actual
                # polygon sizes.
                is_last = name == elements[-1][0]
                fast_len = tri_dt.itemsize * count
                fast_ok = count > 0 and offset + fast_len <= len(body)
                if fast_ok and is_last:
                    fast_ok = offset + fast_len == len(body)
                if fast_ok:
                    tri = np.frombuffer(body, dtype=tri_dt, count=count, offset=offset)
                    if bool(np.all(tri["n"] == 3)):
                        rows = tri["idx"].astype(np.int64)
                        offset += fast_len
                if not len(rows):
                    for _ in range(count):
                        if offset + cnt_size > len(body):
                            raise PlyError("truncated face element")
                        n = int(
                            np.frombuffer(
                                body, dtype=endian + _DTYPES[cnt_dt], count=1,
                                offset=offset,
                            )[0]
                        )
                        offset += cnt_size
                        if n < 0 or offset + idx_size * n > len(body):
                            raise PlyError("truncated face element")
                        idx = np.frombuffer(
                            body, dtype=endian + _DTYPES[idx_dt], count=n, offset=offset
                        )
                        offset += idx_size * n
                        rows.append([int(i) for i in idx])
            if isinstance(rows, np.ndarray):
                faces = rows  # fast path already validated n == 3
            else:
                for r in rows:
                    if len(r) != 3:
                        raise PlyError("only triangular faces are supported")
                faces = np.asarray(rows, dtype=np.int64)
        else:
            raise PlyError(f"Unexpected element {name}")

    if points is None:
        raise PlyError("no vertex element")
    return Geometry(points=points, normals=normals, colors=colors, faces=faces)


def _header(geom: Geometry, fmt: str) -> list[str]:
    lines = ["ply", f"format {fmt} 1.0"]
    lines.append(f"element vertex {geom.len_vertices()}")
    lines += [f"property float {k}" for k in ("x", "y", "z")]
    if geom.normals is not None:
        lines += [f"property float {k}" for k in ("nx", "ny", "nz")]
    if geom.colors is not None:
        lines += [f"property uchar {k}" for k in ("red", "green", "blue")]
    if geom.faces is not None:
        lines.append(f"element face {geom.len_faces()}")
        lines.append("property list uchar int vertex_indices")
    lines.append("end_header")
    return lines


def write_ply(filepath, geom: Geometry, binary: bool = False) -> None:
    """PLY writer matching the reference's element layout (ply.rs:144-236).

    ASCII by default like the reference; ``binary=True`` writes
    binary_little_endian (beyond reference — the fast path for large
    clouds; :func:`read_ply` and standard tools read it back).
    """
    n = geom.len_vertices()
    pts = np.asarray(geom.points, np.float32)
    nrm = None if geom.normals is None else np.asarray(geom.normals, np.float32)
    col = None if geom.colors is None else np.asarray(geom.colors, np.uint8)

    if binary:
        fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
        if nrm is not None:
            fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
        if col is not None:
            fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
        vert = np.zeros(n, dtype=np.dtype(fields))
        vert["x"], vert["y"], vert["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
        if nrm is not None:
            vert["nx"], vert["ny"], vert["nz"] = nrm[:, 0], nrm[:, 1], nrm[:, 2]
        if col is not None:
            vert["red"], vert["green"], vert["blue"] = (
                col[:, 0], col[:, 1], col[:, 2],
            )
        with open(filepath, "wb") as fh:
            fh.write(
                ("\n".join(_header(geom, "binary_little_endian")) + "\n").encode()
            )
            fh.write(vert.tobytes())
            if geom.faces is not None:
                f = np.asarray(geom.faces, np.int64)
                tri = np.zeros(
                    f.shape[0], dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
                )
                tri["n"] = 3
                tri["idx"] = f.astype(np.int32)
                fh.write(tri.tobytes())
        return

    lines = _header(geom, "ascii")
    # Vectorized row formatting (a per-row Python loop dominated writes of
    # large clouds).
    cols = [pts]
    if nrm is not None:
        cols.append(nrm)
    body = np.concatenate(cols, axis=1) if len(cols) > 1 else pts
    rows = [" ".join(str(v) for v in row) for row in body]  # f32 shortest repr
    if col is not None:
        crows = [" ".join(str(int(v)) for v in row) for row in col]
        rows = [f"{a} {c}" for a, c in zip(rows, crows)]
    lines += rows
    if geom.faces is not None:
        for f in np.asarray(geom.faces):
            lines.append(f"3 {f[0]} {f[1]} {f[2]}")

    with open(filepath, "w") as fh:
        fh.write("\n".join(lines) + "\n")
