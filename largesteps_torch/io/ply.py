"""PLY mesh reader/writer (ascii + binary little/big endian).

A copy of ``largesteps_tpu/io/ply.py`` (numpy only; the port imports
nothing of the JAX package).

Reference semantics: scripts/io_ply.py — read vertices/normals/faces with
the dtype table (io_ply.py:10-28), triangle-only assertion (io_ply.py:168),
binary-by-default writer with optional normals and uint8 vertex colors
(io_ply.py:174-270).  Host-side numpy; arrays are uploaded by the caller.
"""
from __future__ import annotations

import numpy as np

__all__ = ["read_ply", "write_ply"]

_PLY_DTYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def read_ply(path):
    """Parse a PLY file → dict with 'vertices' (V,3) f32, 'faces' (F,3) i32,
    and optionally 'normals' (V,3) f32 / 'colors' (V,3) u8."""
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        elements = []  # list of (name, count, [(prop_name, dtype_or_list)])
        while True:
            line = fh.readline()
            if not line:
                raise ValueError("unexpected EOF in header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens or tokens[0] == "comment":
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                elements.append((tokens[1], int(tokens[2]), []))
            elif tokens[0] == "property":
                if tokens[1] == "list":
                    elements[-1][2].append(
                        (tokens[4], ("list", _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]]))
                    )
                else:
                    elements[-1][2].append((tokens[2], _PLY_DTYPES[tokens[1]]))
            elif tokens[0] == "end_header":
                break

        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        data = {}
        if fmt == "ascii":
            text_rows = fh.read().split(b"\n")
            row_iter = iter(r.split() for r in text_rows if r.strip())
            for name, count, props in elements:
                rows = [next(row_iter) for _ in range(count)]
                data[name] = _parse_ascii_element(rows, props)
        else:
            for name, count, props in elements:
                data[name] = _parse_binary_element(fh, count, props, endian)

    out = {}
    vert = data.get("vertex")
    if vert is not None:
        out["vertices"] = np.stack(
            [vert["x"], vert["y"], vert["z"]], axis=1
        ).astype(np.float32)
        if all(k in vert for k in ("nx", "ny", "nz")):
            out["normals"] = np.stack(
                [vert["nx"], vert["ny"], vert["nz"]], axis=1
            ).astype(np.float32)
        if all(k in vert for k in ("red", "green", "blue")):
            out["colors"] = np.stack(
                [vert["red"], vert["green"], vert["blue"]], axis=1
            ).astype(np.uint8)
    face = data.get("face")
    if face is not None:
        key = "vertex_indices" if "vertex_indices" in face else "vertex_index"
        faces = face[key]
        assert faces.shape[1] == 3, "Only triangle meshes are supported"
        out["faces"] = faces.astype(np.int32)
    return out


def _parse_ascii_element(rows, props):
    cols = {}
    has_list = any(isinstance(d, tuple) for _, d in props)
    if has_list:
        # assume single list property (face element)
        name = props[0][0]
        counts = {int(r[0]) for r in rows}
        assert counts == {3}, "Only triangle meshes are supported"
        cols[name] = np.array([[int(x) for x in r[1:4]] for r in rows])
        return cols
    arr = np.array([[float(x) for x in r] for r in rows])
    for k, (pname, _) in enumerate(props):
        cols[pname] = arr[:, k]
    return cols


def _parse_binary_element(fh, count, props, endian):
    cols = {}
    has_list = any(isinstance(d, tuple) for _, d in props)
    if not has_list:
        dt = np.dtype([(p, endian + d) for p, d in props])
        raw = np.frombuffer(fh.read(dt.itemsize * count), dtype=dt, count=count)
        for p, _ in props:
            cols[p] = np.ascontiguousarray(raw[p])
        return cols
    # list property: peek count from first entry, require uniform (tris)
    pname, (_, cnt_dt, idx_dt) = props[0]
    cnt_size = np.dtype(cnt_dt).itemsize
    idx_size = np.dtype(idx_dt).itemsize
    first = np.frombuffer(fh.read(cnt_size), dtype=endian + cnt_dt)[0]
    assert first == 3, "Only triangle meshes are supported"
    stride = cnt_size + 3 * idx_size
    rest = fh.read(stride * count - cnt_size)
    buf = np.frombuffer(
        np.frombuffer(first.tobytes() + rest, dtype=np.uint8).tobytes(), dtype=np.uint8
    ).reshape(count, stride)
    counts = buf[:, :cnt_size].copy().view(endian + cnt_dt)[:, 0]
    assert (counts == 3).all(), "Only triangle meshes are supported"
    idx = buf[:, cnt_size:].copy().view(endian + idx_dt)
    cols[pname] = idx.astype(np.int64)
    return cols


def write_ply(path, vertices, faces, normals=None, colors=None, ascii_: bool = False):
    """Write a triangle mesh as PLY (binary little-endian by default,
    reference io_ply.py:174-270)."""
    vertices = np.asarray(vertices, np.float32)
    faces = np.asarray(faces, np.int32)
    props = ["property float x", "property float y", "property float z"]
    if normals is not None:
        props += ["property float nx", "property float ny", "property float nz"]
    if colors is not None:
        props += ["property uchar red", "property uchar green", "property uchar blue"]
    header = [
        "ply",
        "format ascii 1.0" if ascii_ else "format binary_little_endian 1.0",
        f"element vertex {len(vertices)}",
        *props,
        f"element face {len(faces)}",
        "property list uchar int vertex_indices",
        "end_header",
    ]
    with open(path, "wb") as fh:
        fh.write(("\n".join(header) + "\n").encode("ascii"))
        if ascii_:
            for i, v in enumerate(vertices):
                row = list(v)
                if normals is not None:
                    row += list(np.asarray(normals[i], np.float32))
                if colors is not None:
                    row += [int(c) for c in colors[i]]
                fh.write((" ".join(str(x) for x in row) + "\n").encode())
            for f in faces:
                fh.write(f"3 {f[0]} {f[1]} {f[2]}\n".encode())
        else:
            fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
            if normals is not None:
                fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
            if colors is not None:
                fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
            rec = np.empty(len(vertices), dtype=np.dtype(fields))
            rec["x"], rec["y"], rec["z"] = vertices.T
            if normals is not None:
                n = np.asarray(normals, np.float32)
                rec["nx"], rec["ny"], rec["nz"] = n.T
            if colors is not None:
                c = np.asarray(colors, np.uint8)
                rec["red"], rec["green"], rec["blue"] = c.T
            fh.write(rec.tobytes())
            frec = np.empty(
                len(faces), dtype=np.dtype([("n", "u1"), ("idx", "<i4", (3,))])
            )
            frec["n"] = 3
            frec["idx"] = faces
            fh.write(frec.tobytes())
