"""PLY meshes, ASCII and binary (port of rtjax.scene.mesh): ``load_ply``
and ``save_ply`` for triangle meshes, and ``PlyData`` with
``load_ply_data`` / ``save_ply_data`` for every element and property of a
file (the general surface of the reference's happly.h)."""

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


def _parse_header(f) -> tuple[str, list, list]:
    if f.readline().strip() not in (b"ply", b"ply\r"):
        raise ValueError("not a PLY file")
    fmt = None
    elements: list[_Element] = []
    comments: list[str] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        text = line.decode("ascii", "replace")
        tokens = text.split()
        if not tokens:
            continue
        if tokens[0] in ("comment", "obj_info"):
            comments.append(text.strip())
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
    return fmt, elements, comments


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


def _read_file(path):
    """``(format, elements, header comments, data)`` of a PLY file."""
    with open(path, "rb") as f:
        fmt, elements, comments = _parse_header(f)
        if fmt == "ascii":
            data = _read_ascii(io.TextIOWrapper(f, "ascii"), elements)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            data = _read_binary(f, elements, endian)
    return fmt, elements, comments, data


def load_ply(path) -> Mesh:
    """Vertex positions + triangulated face indices of a PLY file."""
    _, _, _, data = _read_file(path)
    vdata = data["vertex"]
    vertices = np.stack([np.asarray(vdata["x"]), np.asarray(vdata["y"]),
                         np.asarray(vdata["z"])], axis=1).astype(np.float64)
    faces = np.zeros((0, 3), np.int64)
    if "face" in data:
        fdata = data["face"]
        key = "vertex_indices" if "vertex_indices" in fdata else "vertex_index"
        faces = _triangulate(fdata[key])
    return Mesh(vertices=vertices, faces=faces)


def save_ply(path, mesh: Mesh, binary: bool = False,
             big_endian: bool = False) -> None:
    """Write a triangle mesh as PLY: ASCII, or with ``binary=True`` binary
    1.0, little-endian unless ``big_endian`` (happly.h:1730's formats).
    Vertices are declared float32: ASCII keeps the float64 values' full
    digits, binary narrows them when packing, as rtjax's writer does."""
    data = PlyData(comments=[])
    data.add_element("vertex", {
        "x": np.asarray(mesh.vertices[:, 0], np.float64),
        "y": np.asarray(mesh.vertices[:, 1], np.float64),
        "z": np.asarray(mesh.vertices[:, 2], np.float64)})
    data.add_element("face", {
        "vertex_indices": [np.asarray(fc, np.int64) for fc in mesh.faces]})
    fmt = ("binary_big_endian" if big_endian else "binary_little_endian") \
        if binary else "ascii"
    save_ply_data(path, data, fmt=fmt)


# generic PLY access: happly.h's general surface (happly.h:123-1232),
# every element and property, not only vertex positions and faces


@dataclasses.dataclass
class PlyData:
    """Generic PLY contents: ``elements[element][property]`` is a float64
    ``[count]`` array for scalar properties or a list of int64 arrays for
    list properties (happly's getElement/getProperty surface).
    ``dtypes[element][property]`` records the declared on-disk type
    (numpy char codes; ``(count_dtype, dtype)`` for lists) so writes
    round-trip the original declarations.
    """

    comments: list = dataclasses.field(default_factory=list)
    elements: dict = dataclasses.field(default_factory=dict)
    dtypes: dict = dataclasses.field(default_factory=dict)

    def add_element(self, name: str, props: dict, dtypes: dict | None = None):
        """Register an element from {prop: array-or-list-of-arrays}.
        Declared types default to float32 scalars / (uchar, int) lists."""
        self.elements[name] = props
        dts = dict(dtypes or {})
        for pname, val in props.items():
            if pname not in dts:
                dts[pname] = ("u1", "i4") if _is_list_prop(val) else "f4"
        self.dtypes[name] = dts
        return self

    def counts(self, name: str) -> int:
        props = self.elements[name]
        first = next(iter(props.values()))
        return len(first)


def _is_list_prop(val) -> bool:
    return isinstance(val, list) or (
        isinstance(val, np.ndarray) and val.dtype == object)


def load_ply_data(path) -> PlyData:
    """Read a PLY file's FULL contents: every element, every property
    (scalars as float64 arrays, lists as lists of int64 arrays), plus
    header comments — happly.h's general accessor surface."""
    fmt, elements, comments, data = _read_file(path)
    out = PlyData(comments=comments)
    for elem in elements:
        props = {}
        dts = {}
        for p in elem.properties:
            val = data[elem.name][p.name]
            if p.is_list:
                dts[p.name] = (p.count_dtype, p.dtype)
                props[p.name] = list(val)
            else:
                dts[p.name] = p.dtype
                props[p.name] = np.asarray(val, np.float64)
        out.elements[elem.name] = props
        out.dtypes[elem.name] = dts
    return out


_DTYPE_NAMES = {
    "i1": "char", "u1": "uchar", "i2": "short", "u2": "ushort",
    "i4": "int", "u4": "uint", "f4": "float", "f8": "double",
}


def save_ply_data(path, data: PlyData, fmt: str = "ascii") -> None:
    """Write a :class:`PlyData` in any of the three PLY formats
    (``ascii``, ``binary_little_endian``, ``binary_big_endian``) —
    happly.h's full write surface (happly.h:1724-1733)."""
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    lines = ["ply", f"format {fmt} 1.0"]
    lines += [c if c.startswith(("comment", "obj_info")) else f"comment {c}"
              for c in data.comments]
    for ename, props in data.elements.items():
        lines.append(f"element {ename} {data.counts(ename)}")
        for pname, val in props.items():
            dt = data.dtypes[ename][pname]
            if _is_list_prop(val):
                cdt, idt = dt
                lines.append(f"property list {_DTYPE_NAMES[cdt]} "
                             f"{_DTYPE_NAMES[idt]} {pname}")
            else:
                lines.append(f"property {_DTYPE_NAMES[dt]} {pname}")
    lines.append("end_header")
    header = "\n".join(lines) + "\n"

    if fmt == "ascii":
        with open(path, "w") as f:
            f.write(header)
            for ename, props in data.elements.items():
                names = list(props)
                for i in range(data.counts(ename)):
                    parts = []
                    for pname in names:
                        val = props[pname]
                        if _is_list_prop(val):
                            row = np.asarray(val[i])
                            parts.append(" ".join(
                                [str(len(row))] + [_fmt_ascii(x, data.dtypes[
                                    ename][pname][1]) for x in row]))
                        else:
                            parts.append(_fmt_ascii(val[i],
                                                    data.dtypes[ename][pname]))
                    f.write(" ".join(parts) + "\n")
        return

    endian = "<" if fmt == "binary_little_endian" else ">"
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        for ename, props in data.elements.items():
            names = list(props)
            has_list = any(_is_list_prop(props[p]) for p in names)
            if not has_list:
                dt = np.dtype([(p, endian + data.dtypes[ename][p])
                               for p in names])
                arr = np.zeros(data.counts(ename), dt)
                for p in names:
                    arr[p] = props[p]
                f.write(arr.tobytes())
                continue
            for i in range(data.counts(ename)):
                for pname in names:
                    val = props[pname]
                    if _is_list_prop(val):
                        cdt, idt = data.dtypes[ename][pname]
                        row = np.asarray(val[i])
                        f.write(np.asarray([len(row)],
                                           endian + cdt).tobytes())
                        f.write(np.asarray(row, endian + idt).tobytes())
                    else:
                        f.write(np.asarray(
                            [val[i]],
                            endian + data.dtypes[ename][pname]).tobytes())


def _fmt_ascii(x, dtype_code: str) -> str:
    if dtype_code.startswith(("i", "u")):
        return str(int(x))
    return repr(float(x))
