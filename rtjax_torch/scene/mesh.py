"""PLY mesh loading (ASCII and binary), port of rtjax.scene.mesh.load_ply."""

from __future__ import annotations

import dataclasses
import io

import numpy as np

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


@dataclasses.dataclass
class _Property:
    name: str
    dtype: str
    is_list: bool = False
    count_dtype: str = ""


@dataclasses.dataclass
class _Element:
    name: str
    count: int
    properties: list


@dataclasses.dataclass
class Mesh:
    """Float64 vertex positions and int64 fan-triangulated faces."""

    vertices: np.ndarray  # [V, 3] float64
    faces: np.ndarray     # [F, 3] int64


def _parse_header(f) -> tuple[str, list]:
    if f.readline().strip() not in (b"ply", b"ply\r"):
        raise ValueError("not a PLY file")
    fmt = None
    elements: list[_Element] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").split()
        if not tokens or tokens[0] in ("comment", "obj_info"):
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append(_Element(tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                prop = _Property(tokens[4], _PLY_DTYPES[tokens[3]], True,
                                 _PLY_DTYPES[tokens[2]])
            else:
                prop = _Property(tokens[2], _PLY_DTYPES[tokens[1]])
            elements[-1].properties.append(prop)
        elif tokens[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return fmt, elements


def _read_ascii(f, elements):
    tokens = f.read().split()
    pos = 0
    data = {}
    for elem in elements:
        if not any(p.is_list for p in elem.properties):
            width = len(elem.properties)
            flat = np.array(tokens[pos:pos + elem.count * width],
                            dtype=np.float64)
            pos += elem.count * width
            data[elem.name] = {p.name: flat.reshape(elem.count, width)[:, i]
                               for i, p in enumerate(elem.properties)}
            continue
        rows = {p.name: [] for p in elem.properties}
        for _ in range(elem.count):
            for p in elem.properties:
                if p.is_list:
                    n = int(tokens[pos])
                    pos += 1
                    rows[p.name].append(
                        np.array(tokens[pos:pos + n], dtype=np.int64))
                    pos += n
                else:
                    rows[p.name].append(float(tokens[pos]))
                    pos += 1
        data[elem.name] = rows
    return data


def _read_binary(f, elements, endian):
    buf = f.read()
    off = 0
    data = {}
    for elem in elements:
        if not any(p.is_list for p in elem.properties):
            dt = np.dtype([(p.name, endian + p.dtype)
                           for p in elem.properties])
            arr = np.frombuffer(buf, dtype=dt, count=elem.count, offset=off)
            off += dt.itemsize * elem.count
            data[elem.name] = {p.name: arr[p.name].astype(np.float64)
                               for p in elem.properties}
            continue
        if len(elem.properties) == 1:
            p = elem.properties[0]
            cdt = np.dtype(endian + p.count_dtype)
            idt = np.dtype(endian + p.dtype)
            # uniform list length (every triangulated mesh): one reshape
            first_n = int(np.frombuffer(buf, cdt, 1, off)[0])
            stride = cdt.itemsize + first_n * idt.itemsize
            end = off + stride * elem.count
            if len(buf) >= end:
                block = np.frombuffer(buf, np.uint8, stride * elem.count,
                                      off).reshape(elem.count, stride)
                counts = block[:, :cdt.itemsize].copy().view(cdt).ravel()
                if np.all(counts == first_n):
                    idx = block[:, cdt.itemsize:].copy().view(idt)
                    idx = idx.reshape(elem.count, first_n).astype(np.int64)
                    data[elem.name] = {p.name: list(idx)}
                    off = end
                    continue
        # ragged or mixed list/scalar rows: row-wise parse
        rows = {p.name: [] for p in elem.properties}
        for _ in range(elem.count):
            for p in elem.properties:
                if p.is_list:
                    cdt = np.dtype(endian + p.count_dtype)
                    idt = np.dtype(endian + p.dtype)
                    n = int(np.frombuffer(buf, cdt, 1, off)[0])
                    off += cdt.itemsize
                    rows[p.name].append(
                        np.frombuffer(buf, idt, n, off).astype(np.int64))
                    off += n * idt.itemsize
                else:
                    sdt = np.dtype(endian + p.dtype)
                    rows[p.name].append(
                        float(np.frombuffer(buf, sdt, 1, off)[0]))
                    off += sdt.itemsize
        data[elem.name] = rows
    return data


def _triangulate(faces) -> np.ndarray:
    """Fan-triangulate polygon faces into an [F, 3] int64 array."""
    if len(faces) == 0:
        return np.zeros((0, 3), np.int64)
    if all(len(fc) == 3 for fc in faces):
        return np.asarray(np.stack(faces), np.int64)
    tris = [(fc[0], fc[k], fc[k + 1])
            for fc in faces for k in range(1, len(fc) - 1)]
    return np.array(tris, np.int64).reshape(-1, 3)


def load_ply(path) -> Mesh:
    """Vertex positions + triangulated face indices of a PLY file."""
    with open(path, "rb") as f:
        fmt, elements = _parse_header(f)
        if fmt == "ascii":
            data = _read_ascii(io.TextIOWrapper(f, "ascii"), elements)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            data = _read_binary(f, elements, endian)
    vdata = data["vertex"]
    vertices = np.stack([np.asarray(vdata["x"]), np.asarray(vdata["y"]),
                         np.asarray(vdata["z"])], axis=1).astype(np.float64)
    faces = np.zeros((0, 3), np.int64)
    if "face" in data:
        fdata = data["face"]
        key = "vertex_indices" if "vertex_indices" in fdata else "vertex_index"
        faces = _triangulate(fdata[key])
    return Mesh(vertices=vertices, faces=faces)
