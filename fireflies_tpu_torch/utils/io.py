"""Host-side IO (port of fireflies_tpu/utils/io.py): YAML configs, OBJ / PLY
/ Mitsuba serialized meshes, OBJ frame sequences, Blender NURBS curves and
the projection matrix.

YAML goes through this module's own reader and writer (`yaml_loads`,
`yaml_dumps`), so that the package needs no YAML library.  They cover the
subset that `yaml.safe_dump` writes and scene descriptions use: block
mappings and sequences (sequences of mappings, of sequences and of
scalars), flow sequences and mappings (JSON among them), plain, single-
and double-quoted scalars resolved as YAML 1.1 does (null, booleans, ints,
floats; `1e5` stays a string, `1.0e+5` is a float), comments, anchors and
aliases (`&a` / `*a`), the merge key (`<<`), and literal and folded block
scalars (`|`, `>`, with the `-` / `+` chomping and an indentation
indicator), as `yaml.safe_load` reads them.  Tags (`!`), directives,
complex keys and timestamps raise ValueError or stay strings.  OBJ files
are read by the Python parser (fan triangulation, negative indices,
per-face uv indices).
"""

from __future__ import annotations

import json
import math
import os
import re
import struct
import zlib
from pathlib import Path

import numpy as np

from fireflies_tpu_torch.utils.nurbs import NURBSCurve

# ---------------------------------------------------------------------------
# YAML
# ---------------------------------------------------------------------------

_BOOL = {v: True for v in ("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON")}
_BOOL.update({v: False for v in ("no", "No", "NO", "false", "False", "FALSE", "off", "Off",
                                 "OFF")})
_NULL = ("~", "null", "Null", "NULL", "")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+
    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": " ", "P": " "}


def _sexagesimal(digits: str, convert) -> float:
    value = 0
    for part in digits.split(":"):
        value = value * 60 + convert(part)
    return value


def _resolve(text: str):
    """A plain scalar as YAML 1.1's implicit resolvers (PyYAML's) read it."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v[1:] if v[0] in "+-" else v
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if ":" in v:
            return sign * _sexagesimal(v, int)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * int(v)
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v[1:] if v[0] in "+-" else v
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        if ":" in v:
            return sign * _sexagesimal(v, float)
        return sign * float(v)
    return text


def _quoted_end(text: str, start: int) -> int:
    """The index just past the quoted scalar that opens at text[start]."""
    quote = text[start]
    i = start + 1
    while i < len(text):
        c = text[i]
        if quote == '"' and c == "\\":
            i += 2
            continue
        if c == quote:
            if quote == "'" and text[i + 1:i + 2] == "'":
                i += 2
                continue
            return i + 1
        i += 1
    raise ValueError(f"unterminated quoted scalar: {text[start:]!r}")


def _fold(text: str) -> str:
    """A quoted scalar's lines folded: a line break becomes a space, or n
    newlines where n empty lines follow it."""
    parts = text.split("\n")
    out, empties = parts[0], 0
    if len(parts) > 1:
        out = out.rstrip(" \t")
    for k, part in enumerate(parts[1:], 2):
        part = part.lstrip(" \t") if k == len(parts) else part.strip(" \t")
        if not part and k < len(parts):
            empties += 1
            continue
        out += ("\n" * empties if empties else " ") + part
        empties = 0
    return out


def _unquote(token: str) -> str:
    """The value of a single- or double-quoted scalar."""
    body = _fold(token[1:-1])
    if token[0] == "'":
        return body.replace("''", "'")
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1]
        width = {"x": 2, "u": 4, "U": 8}.get(e)
        if width:
            out.append(chr(int(body[i + 2:i + 2 + width], 16)))
            i += 2 + width
        else:
            out.append(_ESCAPES[e])
            i += 2
    return "".join(out)


def _strip_comment(line: str) -> str:
    """The line without its comment: a '#' at its start or after a space,
    outside quotes."""
    quote = None
    i = 0
    while i < len(line):
        c = line[i]
        if quote:
            if quote == '"' and c == "\\":
                i += 1
            elif c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " \t[{,:-?"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _balanced(text: str) -> bool:
    """True when every flow bracket and quote of `text` is closed."""
    depth, i = 0, 0
    while i < len(text):
        c = text[i]
        if c in "'\"":
            try:
                i = _quoted_end(text, i)
            except ValueError:
                return False
            continue
        depth += c in "[{"
        depth -= c in "]}"
        i += 1
    return depth <= 0


def _map_split(text: str):
    """(key, value) of a block mapping entry 'key: value' / 'key:', or None."""
    i = 0
    if text[:1] in "'\"":
        try:
            i = _quoted_end(text, 0)
        except ValueError:  # a quoted scalar that goes on over the next lines
            return None
        rest = text[i:].lstrip()
        if rest.startswith(":") and (len(rest) == 1 or rest[1] in " \t"):
            return _unquote(text[:i]), rest[1:].strip()
        return None
    if text[:1] in "[{":
        return None
    for j, c in enumerate(text):
        if c == ":" and (j + 1 == len(text) or text[j + 1] in " \t"):
            return _resolve(text[:j].strip()), text[j + 1:].strip()
    return None


def _anchor_split(text: str):
    """(name, rest) of a node that opens with an anchor '&name'."""
    end = 1
    while end < len(text) and text[end] not in " \t\n,[]{}":
        end += 1
    if end == 1:
        raise ValueError(f"empty anchor in {text!r}")
    return text[1:end], text[end:].strip()


def _alias(anchors: dict, name: str):
    if name not in anchors:
        raise ValueError(f"unknown alias *{name}")
    return anchors[name]


def _mapping(pairs: list, merge_keys: set):
    """A mapping from its (key, value) entries in order, the entries whose
    index is in `merge_keys` merged as yaml.safe_load merges '<<': each
    merged mapping (of a list, the earlier ones winning) under the later
    merges and the explicit keys."""
    if not merge_keys:
        return dict(pairs)
    out = {}
    for k, (_, value) in enumerate(pairs):
        if k in merge_keys:
            sources = value if isinstance(value, list) else [value]
            if not all(isinstance(m, dict) for m in sources):
                raise ValueError("a merge key '<<' takes a mapping or a list of mappings")
            for m in reversed(sources):
                out.update(m)
    out.update((key, value) for k, (key, value) in enumerate(pairs) if k not in merge_keys)
    return out


class _Flow:
    """A flow node ([...], {...} or a scalar) parsed from one string."""

    def __init__(self, text: str, anchors: dict):
        self.text, self.i, self.anchors = text, 0, anchors

    def _skip(self) -> None:
        while self.i < len(self.text) and self.text[self.i] in " \t\n":
            self.i += 1

    def _name(self) -> str:
        start = self.i
        while self.i < len(self.text) and self.text[self.i] not in " \t\n,[]{}":
            self.i += 1
        return self.text[start:self.i]

    def node(self, in_map_key: bool = False):
        self._skip()
        c = self.text[self.i:self.i + 1]
        if c == "!":
            raise ValueError(f"unsupported YAML tag in {self.text!r}")
        if c == "*":
            self.i += 1
            return _alias(self.anchors, self._name())
        if c == "&":
            self.i += 1
            name = self._name()
            value = self.node(in_map_key)
            self.anchors[name] = value
            return value
        if c == "[":
            self.i += 1
            items = []
            while True:
                self._skip()
                if self.text[self.i] == "]":
                    self.i += 1
                    return items
                items.append(self.node())
                self._skip()
                if self.text[self.i] == ",":
                    self.i += 1
        if c == "{":
            self.i += 1
            pairs, merges = [], set()
            while True:
                self._skip()
                if self.text[self.i] == "}":
                    self.i += 1
                    return _mapping(pairs, merges)
                if self.text.startswith("<<", self.i):
                    merges.add(len(pairs))
                key = self.node(in_map_key=True)
                self._skip()
                value = None
                if self.text[self.i] == ":":
                    self.i += 1
                    value = self.node()
                    self._skip()
                pairs.append((key, value))
                if self.text[self.i] == ",":
                    self.i += 1
        if c in ("'", '"'):
            end = _quoted_end(self.text, self.i)
            token, self.i = self.text[self.i:end], end
            return _unquote(token)
        start = self.i
        while self.i < len(self.text):
            ch = self.text[self.i]
            if ch in ",]}":
                break
            if ch == ":" and (in_map_key or self.text[self.i + 1:self.i + 2] in ("", " ", "\t",
                                                                                  ",", "]", "}")):
                break
            self.i += 1
        return _resolve(" ".join(self.text[start:self.i].split()))


class _Block:
    """Block-style YAML over the (indent, text, raw line number) of each
    line with content, comments removed; `raw` holds every line."""

    def __init__(self, lines: list, raw: list, final_newline: bool = True):
        self.lines, self.raw, self.i = lines, raw, 0
        self.final_newline = final_newline
        self.anchors: dict = {}

    def _is_item(self, k: int, indent: int) -> bool:
        ind, text, _ = self.lines[k]
        return ind == indent and (text == "-" or text.startswith(("- ", "-\t")))

    def node(self, parent: int):
        ind, text, row = self.lines[self.i]
        if text == "-" or text.startswith(("- ", "-\t")):
            return self.sequence(ind)
        if _map_split(text) is not None:
            return self.mapping(ind)
        self.i += 1
        return self.inline(text, parent, row)

    def sequence(self, indent: int) -> list:
        items = []
        while self.i < len(self.lines) and self._is_item(self.i, indent):
            _, text, row = self.lines[self.i]
            rest = text[1:].lstrip(" \t")
            if not rest or rest.startswith("&") and not _anchor_split(rest)[1]:
                self.i += 1
                if self.i < len(self.lines) and self.lines[self.i][0] > indent:
                    item = self.node(indent)
                else:
                    item = None
                if rest:
                    self.anchors[_anchor_split(rest)[0]] = item
                items.append(item)
                continue
            # The item's content starts a node at its own column.
            self.lines[self.i] = (indent + len(text) - len(rest), rest, row)
            items.append(self.node(indent))
        return items

    def mapping(self, indent: int) -> dict:
        pairs, merges = [], set()
        while self.i < len(self.lines) and self.lines[self.i][0] == indent:
            _, text, row = self.lines[self.i]
            key_anchor = None
            if text.startswith("&"):  # an anchor before an implicit key names the key
                key_anchor, text = _anchor_split(text)
            split = _map_split(text)
            if split is None:
                break
            key, value = split
            if key_anchor is not None:
                self.anchors[key_anchor] = key
            if text.startswith("<<"):
                merges.add(len(pairs))
            elif text.startswith("*"):
                key = _alias(self.anchors, str(key)[1:].strip())
            self.i += 1
            pairs.append((key, self.value(value, indent, row)))
        return _mapping(pairs, merges)

    def value(self, text: str, indent: int, row: int):
        """The value of a mapping entry at column `indent` whose text after
        the ':' is `text` (empty when the value is on the next lines)."""
        if text.startswith("&"):
            name, rest = _anchor_split(text)
            value = self.value(rest, indent, row)
            self.anchors[name] = value
            return value
        if text:
            return self.inline(text, indent, row)
        if self.i < len(self.lines) and self.lines[self.i][0] > indent:
            return self.node(indent)
        if self.i < len(self.lines) and self._is_item(self.i, indent):
            return self.sequence(indent)
        return None

    def inline(self, text: str, parent: int, row: int):
        """A value written on its entry's line (raw line `row`): a flow
        collection or a quoted scalar (continued on the next raw lines until
        closed), or a plain scalar (continued by the lines indented deeper
        than its entry), an alias, an anchored node or a block scalar."""
        if text[0] == "!":
            raise ValueError(f"unsupported YAML construct: {text!r}")
        if text[0] == "*":
            return _alias(self.anchors, text[1:].strip())
        if text[0] == "&":
            name, rest = _anchor_split(text)
            if rest:
                value = self.inline(rest, parent, row)
            elif self.i < len(self.lines) and self.lines[self.i][0] > parent:
                value = self.node(parent)
            else:
                value = None
            self.anchors[name] = value
            return value
        if text[0] in "|>":
            return self.block_scalar(text, parent, row)
        if text[0] in "[{'\"":
            quoted = text[0] in "'\""
            row += 1
            while not _balanced(text) and row < len(self.raw):
                text += "\n" + (self.raw[row] if quoted else _strip_comment(self.raw[row]))
                row += 1
            while self.i < len(self.lines) and self.lines[self.i][2] < row:
                self.i += 1
            flow = _Flow(text, self.anchors)
            value = flow.node()
            rest = text[flow.i:].strip()
            if rest and not rest.startswith("#"):
                raise ValueError(f"unexpected text after {text[:flow.i]!r}")
            return value
        while self.i < len(self.lines) and self.lines[self.i][0] > parent:
            text += " " + self.lines[self.i][1]
            self.i += 1
        return _resolve(text)

    def block_scalar(self, header: str, parent: int, row: int) -> str:
        """A literal (|) or folded (>) block scalar whose header is on raw
        line `row`, inside a collection at column `parent`: its lines are
        the raw lines below that are blank or indented to its column, read
        as PyYAML's scanner reads them (clip, strip (-) or keep (+) the
        final line breaks; an indentation digit counts from `parent`)."""
        m = re.fullmatch(r"([|>])(?:([1-9])([-+]?)|([-+])([1-9]?))?", header)
        if m is None:
            raise ValueError(f"unsupported block scalar header {header!r}")
        folded = m.group(1) == ">"
        chomp = m.group(3) or m.group(4) or ""
        step = int(m.group(2) or m.group(5) or 0)
        min_indent = max(parent + 1, 1)
        raw = self.raw
        r = row + 1
        if step:
            indent = min_indent + step - 1
        else:
            indent = min_indent
            for line in raw[r:]:
                lead = len(line) - len(line.lstrip(" "))
                indent = max(indent, lead)
                if line.strip(" "):
                    break

        def kind(k: int) -> str:
            line = raw[k]
            if len(line) > indent and not line[:indent].strip(" "):
                return "text"
            return "break" if not line.strip(" ") else "end"

        def line_break(k: int) -> str:
            return "\n" if k + 1 < len(raw) or self.final_newline else ""

        chunks, breaks, last_break = [], [], ""
        while r < len(raw) and kind(r) == "break":
            breaks.append(line_break(r))
            r += 1
        while r < len(raw) and kind(r) == "text":
            chunks += breaks
            text = raw[r][indent:]
            chunks.append(text)
            last_break = line_break(r)
            r += 1
            breaks = []
            while r < len(raw) and kind(r) == "break":
                breaks.append(line_break(r))
                r += 1
            if r < len(raw) and kind(r) == "text":
                nxt = raw[r][indent:]
                if (folded and last_break == "\n" and text[0] not in " \t"
                        and nxt[0] not in " \t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(last_break)
        if chomp != "-":
            chunks.append(last_break)
        if chomp == "+":
            chunks += breaks
        while self.i < len(self.lines) and self.lines[self.i][2] < r:
            self.i += 1
        return "".join(chunks)


def yaml_loads(text: str):
    """Parse one YAML document (the subset this module covers; see the
    module docstring)."""
    raw = text.splitlines()
    lines = []
    for row, line in enumerate(raw):
        line = _strip_comment(line)
        if line.strip() and line.strip() not in ("---", "..."):
            lines.append((len(line) - len(line.lstrip(" ")), line.strip(), row))
    if not lines:
        return None
    block = _Block(lines, raw, final_newline=text.endswith(("\n", "\r")))
    value = block.node(-1)
    if block.i != len(lines):
        raise ValueError(f"unparsed YAML from line {lines[block.i][1]!r}")
    return value


def _plain_ok(text: str) -> bool:
    return (bool(text) and text == text.strip() and isinstance(_resolve(text), str)
            and text[0] not in "-?:,[]{}#&*!|>'\"%@`" and not any(c in text for c in ":#,[]{}")
            and all(c.isprintable() for c in text))


def _scalar_text(value) -> str:
    if isinstance(value, np.generic):
        value = value.item()
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        if math.isnan(value):
            return ".nan"
        if math.isinf(value):
            return ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text
    text = str(value)
    if _plain_ok(text):
        return text
    if all(c.isprintable() for c in text):
        return "'" + text.replace("'", "''") + "'"
    return json.dumps(text)


def _dump_lines(node, indent: int) -> list[str]:
    pad = " " * indent
    if isinstance(node, np.ndarray):
        node = node.tolist()
    if isinstance(node, dict):
        lines = []
        for key in sorted(node, key=str):
            value = node[key]
            if isinstance(value, np.ndarray):
                value = value.tolist()
            head = f"{pad}{_scalar_text(key)}:"
            if isinstance(value, dict) and value:
                lines += [head] + _dump_lines(value, indent + 2)
            elif isinstance(value, (list, tuple)) and value:
                lines += [head] + _dump_lines(value, indent)
            else:
                lines.append(f"{head} {_collection_or_scalar(value)}")
        return lines
    if isinstance(node, (list, tuple)):
        lines = []
        for item in node:
            if isinstance(item, np.ndarray):
                item = item.tolist()
            if isinstance(item, (dict, list, tuple)) and item:
                sub = _dump_lines(item, indent + 2)
                lines += [pad + "- " + sub[0][indent + 2:]] + sub[1:]
            else:
                lines.append(f"{pad}- {_collection_or_scalar(item)}")
        return lines
    return [pad + _collection_or_scalar(node)]


def _collection_or_scalar(value) -> str:
    if isinstance(value, dict):
        return "{}"
    if isinstance(value, (list, tuple)):
        return "[]"
    return _scalar_text(value)


def yaml_dumps(data) -> str:
    """Block-style YAML of dicts, lists and scalars, keys sorted, as
    `yaml.safe_dump` lays it out (numpy arrays and scalars are written as
    lists and numbers)."""
    return "\n".join(_dump_lines(data, 0)) + "\n"


def read_config_yaml(file_path: str) -> dict:
    return yaml_loads(Path(file_path).read_text())


def write_yaml(data: dict, file_path: str) -> None:
    Path(file_path).write_text(yaml_dumps(data))


# ---------------------------------------------------------------------------
# Projection matrix
# ---------------------------------------------------------------------------


def build_projection_matrix(fov: float, near_clip: float, far_clip: float) -> np.ndarray:
    """Perspective calibration matrix K (4x4, float32 numpy), pytorch3d
    convention: fov in degrees, square pixels, the camera looking down -Z
    (z_sign = -1), NDC z mapped to [0, 1]."""
    tan_half = math.tan((math.pi / 180.0) * float(fov) / 2.0)
    k = np.zeros((4, 4), np.float32)
    k[0, 0] = 1.0 / tan_half
    k[1, 1] = 1.0 / tan_half
    z_sign = -1.0
    k[3, 2] = z_sign
    k[2, 2] = z_sign * far_clip / (far_clip - near_clip)
    k[2, 3] = -(far_clip * near_clip) / (far_clip - near_clip)
    return k


# ---------------------------------------------------------------------------
# Meshes
# ---------------------------------------------------------------------------


def load_obj(path: str | os.PathLike) -> dict:
    """OBJ loader: vertices (V, 3) float32; faces (F, 3) int32 (quads and
    n-gons fan-triangulated, negative indices counted from the end); uvs
    (T, 2) float32 or None; face_uvs (F, 3) int32 indices into uvs, or
    None unless every face has them; normals (N, 3) float32 or None."""
    vertices: list[list[float]] = []
    uvs: list[list[float]] = []
    normals: list[list[float]] = []
    faces: list[list[int]] = []
    face_uvs: list[list[int]] = []
    has_uv_faces = True

    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("vt "):
                parts = line.split()
                uvs.append([float(parts[1]), float(parts[2])])
            elif line.startswith("vn "):
                parts = line.split()
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                vi, ti = [], []
                for p in line.split()[1:]:
                    comps = p.split("/")
                    idx = int(comps[0])
                    vi.append(idx - 1 if idx > 0 else len(vertices) + idx)
                    if len(comps) > 1 and comps[1]:
                        ti.append(int(comps[1]) - 1)
                    else:
                        ti.append(-1)
                        has_uv_faces = False
                for j in range(1, len(vi) - 1):
                    faces.append([vi[0], vi[j], vi[j + 1]])
                    face_uvs.append([ti[0], ti[j], ti[j + 1]])

    return {
        "vertices": np.asarray(vertices, np.float32),
        "faces": np.asarray(faces, np.int32).reshape(-1, 3),
        "uvs": np.asarray(uvs, np.float32) if uvs else None,
        "face_uvs": (np.asarray(face_uvs, np.int32).reshape(-1, 3)
                     if uvs and has_uv_faces else None),
        "normals": np.asarray(normals, np.float32) if normals else None,
    }


def save_obj(path: str | os.PathLike, vertices, faces) -> None:
    """Write a minimal OBJ: vertices, then 1-based triangle indices."""
    vertices = np.asarray(vertices)
    faces = np.asarray(faces)
    with open(path, "w") as f:
        for v in vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0] + 1} {face[1] + 1} {face[2] + 1}\n")


_PLY_DTYPES = {
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2", "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4", "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
}


def _ply_header(f, path):
    """(format, [(element, count, properties)]) of a PLY header."""
    if f.readline().strip() != b"ply":
        raise ValueError(f"{path}: not a PLY file")
    fmt = None
    elements: list[tuple[str, int, list]] = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError(f"{path}: unterminated PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens or tokens[0] == "comment":
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            elements.append((tokens[1], int(tokens[2]), []))
        elif tokens[0] == "property":
            if tokens[1] == "list":
                elements[-1][2].append(("list", _PLY_DTYPES[tokens[2]], _PLY_DTYPES[tokens[3]],
                                        tokens[4]))
            else:
                elements[-1][2].append(("scalar", _PLY_DTYPES[tokens[1]], tokens[2]))
        elif tokens[0] == "end_header":
            break
    if fmt is None:
        raise ValueError(f"{path}: PLY header missing format")
    return fmt, elements


def load_ply(path: str | os.PathLike) -> dict:
    """Stanford PLY loader (ASCII, binary little- and big-endian), the dict
    of `load_obj`: vertices, faces (n-gons fan-triangulated), uvs (V, 2)
    from s/t, u/v or texture_u/texture_v vertex properties, normals;
    face_uvs None (PLY uvs are per vertex)."""
    with open(path, "rb") as f:
        fmt, elements = _ply_header(f, path)
        endian = {"binary_little_endian": "<", "binary_big_endian": ">"}.get(fmt)
        data: dict = {}
        for name, count, props in elements:
            if endian is None:
                rows = [f.readline().split() for _ in range(count)]
                cols: dict[str, np.ndarray] = {}
                lists: list = []
                scalars = [p for p in props if p[0] == "scalar"]
                for p in props:
                    if p[0] == "list":
                        lists = [[float(x) for x in row[1:1 + int(row[0])]] for row in rows]
                    else:
                        idx = scalars.index(p)
                        cols[p[2]] = np.array([float(r[idx]) for r in rows], np.dtype(p[1]))
                data[name] = {"cols": cols, "lists": lists}
            elif all(p[0] == "scalar" for p in props):
                dtype = np.dtype([(p[2], endian + p[1]) for p in props])
                arr = np.frombuffer(f.read(dtype.itemsize * count), dtype=dtype)
                data[name] = {"cols": {p[2]: arr[p[2]] for p in props}, "lists": []}
            else:
                lists = []
                for _ in range(count):
                    for p in props:
                        if p[0] == "list":
                            n = int(np.frombuffer(f.read(np.dtype(p[1]).itemsize),
                                                  dtype=endian + p[1])[0])
                            vals = np.frombuffer(f.read(np.dtype(p[2]).itemsize * n),
                                                 dtype=endian + p[2])
                            lists.append([int(v) for v in vals])
                        else:
                            f.read(np.dtype(p[1]).itemsize)
                data[name] = {"cols": {}, "lists": lists}

    if "vertex" not in data:
        raise ValueError(f"{path}: PLY has no vertex element")
    vcols = data["vertex"]["cols"]

    def stack(names):
        return np.stack([np.asarray(vcols[a], np.float32) for a in names], -1)

    vertices = stack(("x", "y", "z"))
    normals = stack(("nx", "ny", "nz")) if all(a in vcols for a in ("nx", "ny", "nz")) else None
    uvs = next((stack(pair) for pair in (("s", "t"), ("u", "v"), ("texture_u", "texture_v"))
                if all(a in vcols for a in pair)), None)
    tris = []
    for poly in data.get("face", {"lists": []})["lists"]:
        poly = [int(i) for i in poly]
        for k in range(1, len(poly) - 1):
            tris.append([poly[0], poly[k], poly[k + 1]])
    faces = np.asarray(tris, np.int32) if tris else np.zeros((0, 3), np.int32)
    return {"vertices": vertices, "faces": faces, "uvs": uvs, "face_uvs": None,
            "normals": normals}


_SERIALIZED_MAGIC = 0x041C
# Mitsuba serialized-mesh flags (the format's public specification).
_MTS_HAS_NORMALS = 0x0001
_MTS_HAS_TEXCOORDS = 0x0002
_MTS_HAS_COLORS = 0x0008
_MTS_SINGLE_PRECISION = 0x1000
_MTS_DOUBLE_PRECISION = 0x2000


def load_serialized(path: str | os.PathLike, shape_index: int = 0) -> dict:
    """Mitsuba `.serialized` mesh loader (format 0x041C, versions 3 and 4),
    the dict of `load_obj`.  Each shape is a uint16 magic and version and a
    zlib stream; an offset table (uint32 in v3, uint64 in v4) and a uint32
    shape count close the file.  The inflated body: uint32 flags, a
    null-terminated name, uint64 vertex and triangle counts, then positions,
    normals, texcoords, colours and indices as the flags say."""
    raw = Path(path).read_bytes()
    if len(raw) < 8:
        raise ValueError(f"{path}: truncated serialized file")
    magic, version = struct.unpack_from("<HH", raw, 0)
    if magic != _SERIALIZED_MAGIC:
        raise ValueError(f"{path}: bad magic 0x{magic:04X} (not .serialized)")
    if version not in (3, 4):
        raise ValueError(f"{path}: unsupported serialized version {version}")
    (count,) = struct.unpack_from("<I", raw, len(raw) - 4)
    osize = 8 if version >= 4 else 4
    table_at = len(raw) - 4 - osize * count
    if count == 0 or table_at < 4:
        raise ValueError(f"{path}: corrupt shape dictionary")
    offsets = struct.unpack_from(f"<{count}{'Q' if version >= 4 else 'I'}", raw, table_at)
    if not 0 <= shape_index < count:
        raise IndexError(f"{path}: shape_index {shape_index} of {count}")
    start = offsets[shape_index] + 4  # past the shape's magic and version
    end = offsets[shape_index + 1] if shape_index + 1 < count else table_at
    body = zlib.decompress(raw[start:end])

    pos = 4
    (flags,) = struct.unpack_from("<I", body, 0)
    pos = body.index(b"\0", pos) + 1  # the shape's name
    n_verts, n_tris = struct.unpack_from("<QQ", body, pos)
    pos += 16
    fdt = np.dtype("<f8") if flags & _MTS_DOUBLE_PRECISION else np.dtype("<f4")

    def take(n, dt):
        nonlocal pos
        arr = np.frombuffer(body, dt, count=n, offset=pos)
        pos += n * dt.itemsize
        return arr

    vertices = take(3 * n_verts, fdt).reshape(-1, 3).astype(np.float32)
    normals = (take(3 * n_verts, fdt).reshape(-1, 3).astype(np.float32)
               if flags & _MTS_HAS_NORMALS else None)
    uvs = (take(2 * n_verts, fdt).reshape(-1, 2).astype(np.float32)
           if flags & _MTS_HAS_TEXCOORDS else None)
    if flags & _MTS_HAS_COLORS:
        take(3 * n_verts, fdt)  # vertex colours: read past
    idt = np.dtype("<u8") if n_verts > 0xFFFFFFFF else np.dtype("<u4")
    faces = take(3 * n_tris, idt).reshape(-1, 3).astype(np.int32)
    return {"vertices": vertices, "faces": faces, "uvs": uvs, "face_uvs": None,
            "normals": normals}


def save_serialized(path: str | os.PathLike, meshes: list[dict]) -> None:
    """Write meshes (dicts with vertices, faces and optionally uvs, normals
    and a name) as one Mitsuba `.serialized` v4 file, single precision."""
    blobs = []
    for m in meshes:
        v = np.ascontiguousarray(m["vertices"], "<f4")
        f = np.ascontiguousarray(m["faces"], "<u4")
        uvs, normals = m.get("uvs"), m.get("normals")
        flags = _MTS_SINGLE_PRECISION
        if normals is not None:
            flags |= _MTS_HAS_NORMALS
        if uvs is not None:
            flags |= _MTS_HAS_TEXCOORDS
        body = struct.pack("<I", flags) + str(m.get("name", "mesh")).encode() + b"\0"
        body += struct.pack("<QQ", v.shape[0], f.shape[0]) + v.tobytes()
        if normals is not None:
            body += np.ascontiguousarray(normals, "<f4").tobytes()
        if uvs is not None:
            body += np.ascontiguousarray(uvs, "<f4").tobytes()
        body += f.tobytes()
        blobs.append(struct.pack("<HH", _SERIALIZED_MAGIC, 4) + zlib.compress(body))

    out = b""
    offsets = []
    for blob in blobs:
        offsets.append(len(out))
        out += blob
    out += struct.pack(f"<{len(blobs)}Q", *offsets) + struct.pack("<I", len(blobs))
    Path(path).write_bytes(out)


def load_mesh(path: str | os.PathLike, shape_index: int = 0) -> dict:
    """Load a .obj, .ply or .serialized mesh by its suffix."""
    suffix = Path(path).suffix.lower()
    if suffix == ".ply":
        return load_ply(path)
    if suffix == ".serialized":
        return load_serialized(path, shape_index=shape_index)
    return load_obj(path)


def load_obj_sequence(directory: str | os.PathLike) -> np.ndarray:
    """The vertices of a directory's OBJ frames, sorted by name, as an
    (F, V, 3) stack; every frame must have the first frame's vertex count."""
    paths = sorted(p for p in Path(directory).iterdir() if p.suffix.lower() == ".obj")
    if not paths:
        raise FileNotFoundError(f"no .obj files in {directory}")
    frames = [load_obj(p)["vertices"] for p in paths]
    for p, fr in zip(paths, frames):
        if fr.shape[0] != frames[0].shape[0]:
            raise ValueError(f"frame {p} has {fr.shape[0]} verts, expected {frames[0].shape[0]}")
    return np.stack(frames)


def import_blender_nurbs_obj(path: str | os.PathLike) -> NURBSCurve:
    """A NURBS curve from Blender's OBJ export ('v', 'deg' and 'parm u'
    lines)."""
    control_points: list[list[float]] = []
    degree = None
    knots = None
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                control_points.append([float(x) for x in line[2:].split()])
            elif line.startswith("deg "):
                degree = int(line[4:].strip())
            elif line.startswith("parm u "):
                knots = [float(x) for x in line[7:].split()]
    if degree is None or knots is None or not control_points:
        raise ValueError(f"{path} is not a Blender NURBS OBJ export")
    return NURBSCurve.create(np.asarray(control_points, np.float32)[:, :3], knots, degree)
