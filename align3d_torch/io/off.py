"""OFF mesh reader (port of ``align3d_tpu/io/off.py``; reference ``src/io/off.rs``).

Line-tracked parse errors; quads are triangulated by fan split
(off.rs:78-86); faces with more than 4 vertices are rejected.
"""

from __future__ import annotations

import numpy as np

from align3d_torch.io.geometry import Geometry


class OffError(ValueError):
    def __init__(self, line_no: int, message: str):
        super().__init__(f"line {line_no}: {message}")


def read_off(filepath) -> Geometry:
    with open(filepath) as f:
        raw_lines = f.readlines()

    # Strip comments/blank lines but remember original numbers for errors.
    lines: list[tuple[int, str]] = []
    for i, line in enumerate(raw_lines, start=1):
        s = line.strip()
        if s and not s.startswith("#"):
            lines.append((i, s))

    idx = 0
    ln, s = lines[idx]
    if s != "OFF":
        raise OffError(ln, f"expected OFF header, got {s!r}")
    idx += 1

    ln, s = lines[idx]
    try:
        n_verts, n_faces, _n_edges = (int(t) for t in s.split())
    except ValueError as e:
        raise OffError(ln, f"bad counts line: {e}") from e
    idx += 1

    pts = np.zeros((n_verts, 3), np.float32)
    for i in range(n_verts):
        ln, s = lines[idx + i]
        tok = s.split()
        if len(tok) < 3:
            raise OffError(ln, "vertex needs 3 coordinates")
        try:
            pts[i] = [float(t) for t in tok[:3]]
        except ValueError as e:
            raise OffError(ln, f"bad vertex: {e}") from e
    idx += n_verts

    tris: list[list[int]] = []
    for i in range(n_faces):
        ln, s = lines[idx + i]
        tok = s.split()
        try:
            cnt = int(tok[0])
            vs = [int(t) for t in tok[1 : 1 + cnt]]
        except (ValueError, IndexError) as e:
            raise OffError(ln, f"bad face: {e}") from e
        if cnt == 3:
            tris.append(vs)
        elif cnt == 4:
            tris.append([vs[0], vs[1], vs[2]])
            tris.append([vs[0], vs[2], vs[3]])
        else:
            raise OffError(ln, f"unsupported face arity {cnt}")

    faces = np.asarray(tris, np.int64) if tris else None
    return Geometry(points=pts, faces=faces)
